"""A multi-rank dry run of the parallel layer (the port's analog of
``__graft_entry__.dryrun_multichip``), and the rank launcher it and the
tests use.

``dryrun_multichip(n)`` starts ``n`` ranks (gloo on the CPU, or one NCCL
rank per visible card) and runs, on tiny shapes, the surfaces JAX's dry
run runs on its virtual mesh: the data-parallel LittleNet step, the
pipelined GRU scan, the stateful (BatchNorm) DCCRN step, each rank's
batched serving step (plain, and kernel K3 on a card), and the
tensor-parallel LSTM with ATT-CCRN on a mixed data x model mesh.

  python -m aec_tpu_torch.parallel.dryrun --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A loopback TCP port free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}


def _rank_main(fn, rank: int, world: int, port: int, args_path: str, results) -> None:
    """One rank: the ``AEC_*`` variables of a ``world``-rank group on
    ``port``, one intra-op thread, ``fn(rank, world, *args)`` with the
    arguments pickled at ``args_path``; its value or its traceback goes to
    ``results``."""
    os.environ.update(AEC_COORDINATOR=f"127.0.0.1:{port}", AEC_NUM_PROCESSES=str(world),
                      AEC_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)  # written by run_ranks in this run
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (spawn),
    each with the ``AEC_*`` environment of one group on a free loopback
    port (``fn`` starts the group, e.g. with
    ``mesh.distributed_init_if_needed``), and return the ranks' values in
    rank order. ``fn`` and its values must pickle. A rank that raises, dies
    or outlasts ``timeout`` seconds fails the run: RuntimeError, every rank
    stopped."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # the arguments go through a file: a large pickle on the start pipe
    # would hold each start until the child before it has read it
    fd, args_path = tempfile.mkstemp(suffix=".pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args_path, results),
                         daemon=True) for r in range(world)]
    got: dict[int, tuple[bool, object]] = {}
    deadline = time.monotonic() + timeout
    # one BLAS / OpenMP thread a rank from its first import (numpy's BLAS
    # too, which torch.set_num_threads does not reach): ranks that each
    # took every core would share them
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(_ONE_THREAD)
    try:
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if not p.is_alive() and r not in got]
                if dead and results.empty():
                    time.sleep(0.5)  # a value put just before the exit
                    if results.empty():
                        break
                continue
            got[rank] = (ok, value)
            if not ok:
                break
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        os.unlink(args_path)
    errors = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items()) if not ok]
    missing = [r for r in range(world) if r not in got]
    if errors or missing:
        raise RuntimeError(
            f"{len(errors)} rank(s) failed, {len(missing)} gave nothing (exit codes "
            f"{[p.exitcode for p in procs]}, {timeout:.0f} s limit)\n" + "\n".join(errors))
    return [got[r][1] for r in range(world)]


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """The dry run's surfaces on one rank; returns what they produced."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused
    from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply, att_ccrn_init
    from aec_tpu_torch.models.dccrn import Dccrn, DccrnConfig, dccrn_init, dccrn_loss_v1
    from aec_tpu_torch.models.little_net import little_net_init, little_net_loss
    from aec_tpu_torch.models.tree_net import copy_into, model_state
    from aec_tpu_torch.ops.gru import gru_cell
    from aec_tpu_torch.ops.lstm import lstm_init, lstm_scan
    from aec_tpu_torch.parallel.mesh import distributed_init_if_needed, make_mesh, shard_batch
    from aec_tpu_torch.parallel.seq_scan import pipelined_scan
    from aec_tpu_torch.parallel.tp_lstm import lstm_scan_tp, shard_lstm_params
    from aec_tpu_torch.pipeline.streaming import stream_init_batched, stream_step_batched
    from aec_tpu_torch.train.loop import (
        make_optimizer,
        make_stateful_train_step,
        make_train_step,
    )

    if not distributed_init_if_needed(device=device):
        raise RuntimeError("the rank's group did not come up from AEC_*")
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    mesh = make_mesh()
    out: dict = {"backend": dist.get_backend(), "device": str(dev)}
    rng = np.random.default_rng(0)  # one global batch on every rank
    gen = torch.Generator().manual_seed(0)

    # the data-parallel LittleNet step: each rank its rows of a global batch
    net = little_net_init(generator=gen, device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    opt = make_optimizer(TrainConfig(batch_size=world), 10, net)
    n = 2048
    batch = shard_batch(mesh, {
        "mic": rng.standard_normal((world, n)).astype(np.float32),
        "ref": rng.standard_normal((world, n)).astype(np.float32),
        "near": (0.1 * rng.standard_normal((world, n))).astype(np.float32)}, dev)
    loss = make_train_step(little_net_loss, opt, mesh)(batch["mic"], batch["ref"],
                                                       batch["near"], erb)
    out["loss"] = float(loss)

    # the pipelined GRU scan: frames split over the ranks, the carry handed on
    gru = {k: v.detach() for k, v in net.gru_params().items()}

    def gru_step(h, x_t):
        h_next = gru_cell(gru, h[None], x_t[None] @ gru["w_ih"].T + gru["b_ih"])[0]
        return h_next, h_next

    xs = torch.as_tensor(rng.standard_normal((3, 2 * world, 64)).astype(np.float32),
                         device=dev)
    with torch.no_grad():
        ys, finals = pipelined_scan(gru_step, torch.zeros(32, device=dev), xs, mesh)
    out["pipelined_finals"] = finals.cpu().numpy()

    # the stateful DCCRN step: BatchNorm statistics over the global batch
    dcfg = DccrnConfig(conv_channels=(4, 8, 16), rnn_layers=1)
    dnet = Dccrn(*dccrn_init(dcfg, generator=gen, device=dev), dcfg)
    dstate = model_state(dnet)
    dstep = make_stateful_train_step(
        lambda p, s, mic, far, near, echo: dccrn_loss_v1(p, s, mic, far, near, echo, dcfg,
                                                         train=True),
        make_optimizer(TrainConfig(lr=1e-5), 10, dnet), mesh)
    dbatch = shard_batch(mesh, {k: (0.1 * rng.standard_normal((world, 1024))).astype(np.float32)
                                for k in ("mic", "far", "near", "echo")}, dev)
    new_state, dloss = dstep(dstate, dbatch["mic"], dbatch["far"], dbatch["near"],
                             dbatch["echo"])
    copy_into(dstate, new_state)
    out["dccrn_loss"] = float(dloss)

    # each rank's batched serving step for its 2 streams: the plain stream
    # step, then K3 (its plain version on the CPU), Kalman and NLMS
    scfg = StftConfig()
    blocks = [torch.as_tensor(rng.standard_normal((2, scfg.hop)).astype(np.float32),
                              device=dev) for _ in range(2)]
    with torch.no_grad():
        _, served = stream_step_batched(net, stream_init_batched(2, device=dev), *blocks, erb,
                                        scfg)
        launches = serving_step_fused.launches
        _, k3 = serving_step_fused(net, serving_init(2, device=dev), *blocks, erb)
        _, k3n = serving_step_fused(net, serving_init(2, stage1="nlms", device=dev), *blocks,
                                    erb, stage1="nlms", normalize=True)
    out["serve"] = [x.cpu().numpy() for x in (served, k3, k3n)]
    out["k3_launches"] = serving_step_fused.launches - launches

    # the tensor-parallel LSTM and ATT-CCRN on a mixed data x model mesh
    n_data = max(1, world // 4)
    tp_mesh = make_mesh(n_data=n_data, n_model=world // n_data)
    with torch.no_grad():
        lp = lstm_init(24, 32, generator=gen, device=dev)
        x = torch.as_tensor(rng.standard_normal((2, 9, 24)).astype(np.float32), device=dev)
        ys_tp, (h_tp, _) = lstm_scan_tp(lp, x, tp_mesh)
        ys_dense, (h_dense, _) = lstm_scan(lp, x)
        d, hp = tp_mesh.index("model"), 32 // tp_mesh.shape["model"]
        out["tp_lstm_err"] = max(float((ys_tp - ys_dense[..., d * hp:(d + 1) * hp]).abs().max()),
                                 float((h_tp - h_dense).abs().max()))
        acfg = AttCcrnConfig(channels=(1, 2, 4, 4, 8))
        aparams, astate = att_ccrn_init(acfg, generator=gen, device=dev)
        aparams["lstm"] = shard_lstm_params(aparams["lstm"], tp_mesh)
        amic, afar = (torch.as_tensor(rng.standard_normal((1, 4000)).astype(np.float32),
                                      device=dev) for _ in range(2))
        aout, _ = att_ccrn_apply(aparams, astate, amic, afar, acfg, lstm_mesh=tp_mesh)
    out["att_ccrn_wav"] = aout["wav"].cpu().numpy()

    finite = [out["loss"], out["dccrn_loss"], out["pipelined_finals"], *out["serve"],
              out["att_ccrn_wav"]]
    if not all(np.isfinite(v).all() for v in finite):
        raise RuntimeError(f"rank {rank}: a dry-run surface gave a non-finite value")
    return out


def dryrun_multichip(n_ranks: int, *, device: str | None = None, timeout: float = 600.0) -> list:
    """Run the dry run on ``n_ranks`` ranks: on ``device`` "cuda" one NCCL
    rank per card (the first ``n_ranks`` visible), on "cpu" gloo ranks; by
    default the cards when there are enough of them. Returns each rank's
    results (losses, the pipelined scan's finals, the serving outputs, the
    TP scan's distance from the dense one, ATT-CCRN's wav, K3's launches);
    raises if any rank fails."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() and \
            torch.cuda.device_count() >= n_ranks else "cpu"
    if device == "cuda" and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"{n_ranks} NCCL ranks need {n_ranks} cards, "
                         f"have {torch.cuda.device_count()}")
    return run_ranks(_dryrun_rank, n_ranks, (device,), timeout=timeout)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    a = p.parse_args()
    res = dryrun_multichip(a.ranks, device=a.device)
    print(f"dry run ok on {a.ranks} ranks ({res[0]['backend']}): loss {res[0]['loss']:.6f}, "
          f"dccrn loss {res[0]['dccrn_loss']:.6f}, TP LSTM max|d| "
          f"{max(r['tp_lstm_err'] for r in res):.2e}")
