"""The ranks' side of the port's parallel-layer tests (run by
``aec_tpu_torch.parallel.dryrun.run_ranks`` in fresh gloo processes).

Each worker imports only torch and the port (no JAX: the ranks start fast
and the JAX side runs in the test process), takes numpy inputs, and
returns numpy results for the test to hold against JAX and against the
port's single-process routes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.parallel import global_batch
from aec_tpu_torch.parallel.mesh import distributed_init_if_needed, local_rows, make_mesh
from aec_tpu_torch.train import loop
from aec_tpu_torch.utils import weights

LR = 1e-3


def _grads(net) -> dict:
    return weights.param_tree(net, lambda p: p.grad.numpy().copy())


def _control_update(opt, world: int) -> None:
    """DDP's step: the gradients averaged over the ranks, then the update."""
    for p in opt.net.parameters():
        dist.all_reduce(p.grad)
        p.grad /= world
    opt.update()


def little_net_steps(mesh, world: int, job: dict) -> dict:
    """One make_train_step(mesh=...) step of LittleNet on this rank's rows of
    the global batch, and the control: the same step with each rank's own
    pseudo-norm and DDP's mean gradients, its loss summed over the ranks."""
    from aec_tpu_torch.models.little_net import little_net_loss

    rows = local_rows(mesh, len(job["mic"]))
    mic, ref, near = (torch.from_numpy(job[k][rows]) for k in ("mic", "ref", "near"))
    erb = torch.from_numpy(job["erb"])
    out = {}
    for variant in ("global", "control"):
        net = weights.params_from_jax(job["little"], device="cpu")
        opt = loop.make_optimizer(TrainConfig(lr=LR), 100, net)
        if variant == "global":
            loss = loop.make_train_step(little_net_loss, opt, mesh)(mic, ref, near, erb)
        else:
            opt.adam.zero_grad(set_to_none=True)
            loss, _ = little_net_loss(net, mic, ref, near, erb, sqrt_eps=1e-12)
            loss.backward()
            _control_update(opt, world)
            loss = loss.detach()
            dist.all_reduce(loss)
        out[variant] = {"loss": float(loss), "grads": _grads(net),
                        "params": weights.params_to_jax(net)}
    return out


class _LocalBackward(global_batch._AllSum):
    """The global sum with a backward that keeps each rank's own cotangent
    (no all-reduce): the forward's statistics stay global, their gradient
    does not."""

    @staticmethod
    def backward(ctx, g):
        return g, None


def dccrn_steps(mesh, world: int, job: dict) -> dict:
    """One make_stateful_train_step(mesh=...) step of the narrow DCCRN on
    this rank's rows, and two controls: the local step (BatchNorm statistics
    and loss means of this rank's rows) with DDP's mean gradients, and the
    global step whose BatchNorm all-reduce has no backward (the gradient
    through the statistics kept per rank)."""
    from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_loss_v1
    from aec_tpu_torch.models.tree_net import functional_params, map_tree, model_state

    cfg = DccrnConfig(**job["dccrn_cfg"])
    rows = local_rows(mesh, len(job["batch"][0]))
    batch = [torch.from_numpy(a[rows]) for a in job["batch"]]

    def loss_fn(p, s, *b):
        return dccrn_loss_v1(p, s, *b, cfg, train=True)

    out = {}
    for variant in ("global", "control", "detached"):
        net = weights.dccrn_from_jax(*job["dccrn"], cfg, device="cpu")
        opt = loop.make_optimizer(TrainConfig(lr=LR), 100, net)
        if variant == "control":
            opt.adam.zero_grad(set_to_none=True)
            loss, aux = loss_fn(functional_params(net), model_state(net), *batch)
            loss.backward()
            _control_update(opt, world)
            state, loss = aux["state"], loss.detach()
            dist.all_reduce(loss)
            loss /= world
        else:
            all_sum = global_batch._AllSum
            if variant == "detached":
                global_batch._AllSum = _LocalBackward
            try:
                state, loss = loop.make_stateful_train_step(loss_fn, opt, mesh)(
                    model_state(net), *batch)
            finally:
                global_batch._AllSum = all_sum
        out[variant] = {"loss": float(loss), "grads": _grads(net), "params": weights.param_tree(
            net, lambda p: p.detach().numpy().copy()),
            "state": map_tree(state, lambda v: v.detach().numpy().copy())}
    return out


def steps_worker(rank: int, world: int, job: dict) -> dict:
    """The bring-up (``AEC_*`` -> a gloo group, a second call a no-op, a
    cross-rank sum), then the data-parallel steps of ``job``."""
    did = distributed_init_if_needed(device="cpu")
    again = distributed_init_if_needed(device="cpu")
    total = torch.tensor([rank + 1.0])
    dist.all_reduce(total)
    mesh = make_mesh()
    out = {"init": did, "again": again, "sum": float(total), "backend": dist.get_backend(),
           "shape": dict(mesh.shape), "index": mesh.index("data")}
    out["little"] = little_net_steps(mesh, world, job)
    if "dccrn" in job:
        out["dccrn"] = dccrn_steps(mesh, world, job)
    return out


def scans_worker(rank: int, world: int, job: dict) -> dict:
    """The tensor-parallel LSTM (forward and gradients, on a 1 x world mesh;
    with h0 / c0 on a 2 x (world / 2) mesh), ATT-CCRN with ``lstm_mesh``,
    and the pipelined scan of a GRU step and of ``kalman_step``."""
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.linear.kalman import kalman_init, kalman_step
    from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply
    from aec_tpu_torch.ops.gru import gru_cell
    from aec_tpu_torch.parallel.seq_scan import pipelined_scan
    from aec_tpu_torch.parallel.tp_lstm import lstm_scan_tp, shard_lstm_params

    distributed_init_if_needed(device="cpu")
    out: dict = {}
    tp = make_mesh(n_data=1, n_model=world)
    lp = {k: torch.from_numpy(v) for k, v in job["lstm"].items()}
    x = torch.from_numpy(job["x"])
    with torch.no_grad():
        ys, (h_t, c_t) = lstm_scan_tp(lp, x, tp)
        ys_sharded, _ = lstm_scan_tp(shard_lstm_params(lp, tp), x, tp)
    out["tp"] = {"ys": ys.numpy(), "h": h_t.numpy(), "c": c_t.numpy(),
                 "ys_sharded": ys_sharded.numpy(), "index": tp.index("model")}

    # gradients: this rank's loss is its slice's share of the mean square
    # error; the weights' gradients summed over the axis give the dense ones
    gp = {k: torch.from_numpy(v).requires_grad_() for k, v in job["lstm_g"].items()}
    xg = torch.from_numpy(job["x_g"]).requires_grad_()
    ys, _ = lstm_scan_tp(gp, xg, tp)
    hp = ys.shape[-1]
    d = tp.index("model")
    tgt = torch.from_numpy(job["tgt_g"])[..., d * hp:(d + 1) * hp]
    (torch.sum((ys - tgt) ** 2) / job["tgt_g"].size).backward()
    grads = {}
    for k, v in gp.items():
        g = v.grad.clone()
        dist.all_reduce(g, group=tp.group("model"))
        grads[k] = g.numpy()
    out["tp_grads"] = grads
    out["tp_x_grad"] = xg.grad.numpy()

    # h0 / c0 on a mixed mesh: each data row takes its rows of the batch
    if world >= 4:
        mixed = make_mesh(n_data=2, n_model=world // 2)
        rows = local_rows(mixed, len(job["x_m"]))
        with torch.no_grad():
            ys, (h_t, c_t) = lstm_scan_tp(
                {k: torch.from_numpy(v) for k, v in job["lstm_m"].items()},
                torch.from_numpy(job["x_m"][rows]), mixed,
                h0=torch.from_numpy(job["h0"][rows]), c0=torch.from_numpy(job["c0"][rows]))
        out["mixed"] = {"ys": ys.numpy(), "h": h_t.numpy(), "c": c_t.numpy(),
                        "rows": (rows.start, rows.stop), "index": mixed.index("model")}

    # ATT-CCRN's bottleneck on the model axis
    acfg = AttCcrnConfig(channels=tuple(job["att_channels"]))
    with torch.no_grad():
        net = weights.att_ccrn_from_jax(*job["att"], acfg, device="cpu")
        wav = att_ccrn_apply(net.params(), net.state(), torch.from_numpy(job["att_mic"]),
                             torch.from_numpy(job["att_far"]), acfg, lstm_mesh=tp)[0]["wav"]
    out["att_wav"] = wav.numpy()

    # the pipelined scans on the data axis
    pipe = make_mesh()
    gru = {k: torch.from_numpy(v) for k, v in job["gru"].items()}

    def gru_step(h, x_t):
        h_next = gru_cell(gru, h[None], x_t[None] @ gru["w_ih"].T + gru["b_ih"])[0]
        return h_next, h_next

    kcfg = KalmanConfig(n_blocks=4)

    def kalman(state, xd):
        return kalman_step(kcfg, state, xd[0], xd[1], block=256)

    with torch.no_grad():
        ys, finals = pipelined_scan(gru_step, torch.zeros(4), torch.from_numpy(job["gru_xs"]),
                                    pipe)
        out["gru"] = {"ys": ys.numpy(), "finals": finals.numpy(), "index": pipe.index("data")}
        ys, finals = pipelined_scan(kalman, kalman_init(kcfg, 257),
                                    (torch.from_numpy(job["k_x"]), torch.from_numpy(job["k_d"])),
                                    pipe)
        out["kalman"] = {"ys": ys.numpy(), "finals": {k: v.numpy() for k, v in finals.items()}}
    return out
