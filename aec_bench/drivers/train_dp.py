"""Data-parallel training steps of DCCRN on several cards, as ``cli/train
--mesh`` runs them: one process a card, ``parallel/mesh.distributed_init_if_needed``
(NCCL on the cards, gloo on the CPU), ``make_mesh()``, and
``train/loop.make_stateful_train_step(..., mesh)`` over
``train/generic.make_adapter``'s loss and ``train/loop.Optimizer`` (Adam):
each rank's BatchNorms reduce over the global batch and the gradients are
summed over the ranks before every update (``parallel/global_batch.py``).

Rank 0 is the harness's process; set-up spawns ranks 1 .. ``ranks`` - 1
(``python -m aec_bench.drivers.train_dp``, each on its own card) and keeps
them in step through a store of its own: rank 0 publishes each window
step before it takes it, and after the window publishes the stop. Every
rank makes its pool from the seed and its rank, the weights from the seed
(and takes rank 0's by broadcast), and takes the ``check_steps`` checked
steps, then the window's. The ranks are tied to rank 0: each dies with it
(its parent-death signal), and rank 0 exits (non-zero) when a rank exits
non-zero, when set-up outlasts ``setup_timeout_s`` or a step
``step_timeout_s``, so a broken group exits rather than hangs.

``train_xrt`` is the audio of all ranks' steps (``ranks`` x batch x
seconds a step) over rank 0's wall time. The check holds rank 0's
parameters and BatchNorm statistics after the checked steps, its summed
first gradient and its global losses to the single-process reference
trained on the global batch (the ranks' batches stacked in rank order), as
``dccrn.train`` reads them.

Traffic keys: ``ranks``, ``batch`` (a rank's), ``seconds`` (of an
utterance), ``pool``, ``check_steps``, ``setup_timeout_s``,
``step_timeout_s``, ``scene``.
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import datetime
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers import train

CHILD = "aec_bench.drivers.train_dp"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pool_generator(seed: int, rank: int, device):
    """Rank ``rank``'s scenes: a generator of its own, drawn from the seed."""
    return scenes.generator((int(seed) * 1_000_003 + rank) % (1 << 63), device)


def rank_batches(ctx, rank: int, count: int) -> list:
    """The first ``count`` batches of rank ``rank``'s pool, made on ``ctx.device``."""
    mix = ctx.mix
    n = int(round(mix["seconds"] * ctx.cfg["sample_rate"]))
    g = pool_generator(ctx.seed, rank, ctx.device)
    out = []
    for _ in range(count):
        s = scenes.make(g, mix["batch"], n, mix["scene"], ctx.device)
        out.append((s["mic"], s["far"], s["near"], s["echo"]))
    return out


def child_argv(ctx, rank: int, port: int, ctl: int) -> list:
    """The command of rank ``rank``."""
    return [sys.executable, "-m", CHILD, "--workload", ctx.cell["name"], "--seed",
            str(ctx.seed), "--rank", str(rank), "--port", str(port), "--ctl", str(ctl),
            "--device", ctx.device.type]


def die_with_parent() -> None:
    """This process gets SIGKILL when its parent exits (Linux's
    PR_SET_PDEATHSIG), and a watcher ends it should the parent be gone."""
    parent = os.getppid()
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def dccrn_config(cfg: dict):
    from aec_tpu_torch.models.dccrn import DccrnConfig

    n = cfg["net"]
    return DccrnConfig(conv_channels=tuple(n["conv_channels"]), kernel=tuple(n["kernel"]),
                       stride=tuple(n["stride"]), padding=tuple(n["padding"]),
                       masking_mode=n["masking_mode"], use_clstm=n["use_clstm"],
                       use_cbn=n["use_cbn"], rnn_layers=n["rnn_layers"], v2_head=n["v2_head"])


class Rank:
    """One rank's training object: its pool, the net (rank 0's weights), the
    mesh's step, and the checked steps taken."""

    def __init__(self, ctx, rank: int, world: int, port: int, ctl: int):
        import torch
        import torch.distributed as dist

        from aec_tpu_torch.configs import TrainConfig
        from aec_tpu_torch.models.dccrn import DccrnConfig
        from aec_tpu_torch.models.tree_net import copy_into, functional_params, model_state
        from aec_tpu_torch.parallel.mesh import distributed_init_if_needed, make_mesh
        from aec_tpu_torch.train.generic import make_adapter
        from aec_tpu_torch.train.loop import Optimizer, make_stateful_train_step

        cfg, mix = ctx.cfg, ctx.mix
        self.rank, self.world = rank, world
        self.store = dist.TCPStore("127.0.0.1", ctl, world, rank == 0,
                                   timeout=datetime.timedelta(seconds=mix["setup_timeout_s"]))
        distributed_init_if_needed(f"127.0.0.1:{port}", world, rank, device=ctx.device.type)
        if ctx.device.type == "cuda":
            ctx.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = make_mesh()
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        self.pool = rank_batches(ctx, rank, mix["pool"])
        params, state = self.ref.make_weights(cfg, ctx.seed, ctx.device)
        self.init = self.ref.clone(params), self.ref.clone(state)
        want = dccrn_config(cfg)
        adapter = (make_adapter("dccrn") if want == DccrnConfig()
                   else make_adapter("dccrn", model_cfg=want))
        self.net = adapter.module(params, state)
        with torch.no_grad():
            for t in [*self.net.parameters(), *self.net.buffers()]:
                dist.broadcast(t, 0)
        tc = TrainConfig(lr=cfg["train"]["lr"], batch_size=mix["batch"] * world)
        self.opt = Optimizer(tc, cfg["train"]["steps_per_epoch"], self.net)

        def step_loss(p, s, mic, far, near, echo):
            loss, new_state = adapter.loss(p, s, mic, far, near, echo, True)
            return loss, {"state": new_state}

        step = make_stateful_train_step(step_loss, self.opt, self.mesh)
        self.state = model_state(self.net)

        def program(batch):
            new_state, loss = step(self.state, *batch)
            copy_into(self.state, new_state)
            return loss

        self.program = program
        self.losses = []
        for k in range(mix["check_steps"]):
            self.losses.append(float(self.program(self.pool[k])))
            if k == 0:
                moment = {id(p): self.opt.adam.state[p]["exp_avg"] for p in self.net.parameters()}
                self.grad = {path: (moment[id(p)] / (1.0 - train.BETA1)).clone()
                             for path, p in self.ref.leaves(functional_params(self.net))}
        self.after = {path: p.detach().clone()
                      for path, p in self.ref.leaves(functional_params(self.net))}
        self.after_state = {path: t.clone() for path, t in self.ref.leaves(self.state)}

    def follow(self) -> int:
        """A rank past 0: take a window step each time rank 0 publishes one,
        until it publishes the stop -> the steps taken."""
        k = 0
        while self.store.get(f"go{k}") == b"1":
            self.program(self.pool[(len(self.losses) + k) % len(self.pool)])
            k += 1
        return k

    def close(self) -> None:
        import torch.distributed as dist

        self.program = self.net = self.opt = None
        if dist.is_initialized():
            dist.destroy_process_group()


class Cell(train.Cell):
    """Rank 0, in the harness's process."""

    def __init__(self, ctx):
        mix = ctx.mix
        self.ctx = ctx
        self.world = mix["ranks"]
        self.sr = ctx.cfg["sample_rate"]
        self.n = int(round(mix["seconds"] * self.sr))
        self.children, self.stopping = [], False
        self.beat, self.limit = time.monotonic(), mix["setup_timeout_s"]
        if ctx.device.type == "cuda":
            from aec_tpu_torch.kernels import _build

            _build.build("lstm", "lstm_bwd")  # once, before the ranks would each build them
        port, ctl = free_port(), free_port()
        atexit.register(self.kill)
        threading.Thread(target=self.watch, daemon=True).start()
        import aec_tpu_torch

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ctx.root), str(Path(aec_tpu_torch.__file__).resolve().parents[1]),
             os.environ.get("PYTHONPATH", "")]))
        for r in range(1, self.world):
            self.children.append(subprocess.Popen(child_argv(ctx, r, port, ctl), cwd=ctx.root,
                                                  env=env, stdout=2))
        self.me = Rank(ctx, 0, self.world, port, ctl)
        self.ref, self.pool, self.init = self.me.ref, self.me.pool, self.me.init
        self.losses, self.grad = self.me.losses, self.me.grad
        self.after, self.after_state = self.me.after, self.me.after_state
        self.next, self.k = mix["check_steps"], 0
        self.beat, self.limit = time.monotonic(), mix["step_timeout_s"]

        def program(batch):
            self.me.store.set(f"go{self.k}", "1")
            self.k += 1
            loss = self.me.program(batch)
            self.beat = time.monotonic()
            return loss

        self.program = program

    def watch(self) -> None:
        """Rank 0's watchdog: exit when a rank exits non-zero, or set-up or
        a step outlasts its limit."""
        while not self.stopping:
            time.sleep(0.5)
            for r, p in enumerate(self.children, start=1):
                code = p.poll()
                if code is not None and code != 0 and not self.stopping:
                    self.fail(f"rank {r} exited with {code}")
            if time.monotonic() - self.beat > self.limit and not self.stopping:
                self.fail(f"no step for {self.limit} s")

    def fail(self, why: str) -> None:
        print(f"aec_bench: the data-parallel group broke: {why}", file=sys.stderr, flush=True)
        self.kill()
        os._exit(3)

    def kill(self) -> None:
        for p in self.children:
            if p.poll() is None:
                p.kill()

    def window(self, seconds: float, win) -> dict:
        res = super().window(seconds, win)
        res["e2e"] = {"train_xrt": res["e2e"]["train_xrt"] * self.world}
        res["work"]["ranks"] = self.world
        return res

    def release(self) -> None:
        """Publish the stop, let the ranks finish their steps and exit, and
        close the group."""
        self.me.store.set(f"go{self.k}", "0")
        deadline = time.monotonic() + self.ctx.mix["step_timeout_s"]
        for p in self.children:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.fail("a rank did not stop")
        self.stopping = True
        if any(p.returncode != 0 for p in self.children):
            self.fail(f"ranks exited with {[p.returncode for p in self.children]}")
        self.me.close()
        self.program = None

    def check(self, control: bool = False, fault: str = "") -> dict:
        """``dccrn.train``'s check on the global batch: the single-process
        reference trained on the ranks' checked batches stacked in rank
        order, against rank 0."""
        import torch

        mix = self.ctx.mix
        steps = mix["check_steps"]
        ranks = [self.pool[:steps]] + [rank_batches(self.ctx, r, steps)
                                       for r in range(1, self.world)]
        self.pool = [tuple(torch.cat([b[k][j] for b in ranks]) for j in range(4))
                     for k in range(steps)]
        self.ctx.mix = dict(mix, batch=mix["batch"] * self.world)
        try:
            return super().check(control, fault)
        finally:
            self.ctx.mix = mix


def main(argv=None) -> int:
    """A rank past 0: set up, follow rank 0's steps, exit."""
    ap = argparse.ArgumentParser(description="a rank of aec_bench's data-parallel cell")
    for name in ("--workload", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--seed", "--rank", "--port", "--ctl"):
        ap.add_argument(name, type=int, required=True)
    args = ap.parse_args(argv)
    die_with_parent()
    from aec_bench import bench

    root = Path.cwd()
    bench.set_environment(root)
    import torch

    ctx, _ = bench.context(root, args.workload, args.seed, torch.device(args.device))
    bench.set_precision(ctx.cfg)
    rank = Rank(ctx, args.rank, ctx.mix["ranks"], args.port, args.ctl)
    rank.follow()
    rank.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
