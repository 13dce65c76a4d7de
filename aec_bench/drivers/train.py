"""Training steps back to back: ``train/loop.make_stateful_train_step`` over
``train/generic.make_adapter``'s loss and ``train/loop.Optimizer`` (Adam), as
``GenericTrainer`` runs them.

Set-up makes the weights from the seed and builds one training object (net,
optimizer, step). It drives that object through the first ``check_steps``
steps, on the pool's first batches, through the window's own call; those are
the steps the check follows. The window goes on from there: batches of
(mic, far, near, echo) from a pool on the card, one step after another, the
BatchNorm statistics carried as the trainer carries them, and it ends with the
last loss read back. ``train_xrt`` is the audio of all its steps over its
wall time.

Traffic keys: ``batch``, ``seconds`` (of an utterance), ``pool``,
``check_steps``, ``scene``.
"""

from __future__ import annotations

import time

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers.common import tf32, worst
from aec_bench.trace import span

BETA1 = 0.9  # Adam's first moment, as train/loop.Optimizer sets it
LARGE = 1024  # the least elements of a leaf the gradient and change gaps are read on


class Cell:
    def __init__(self, ctx):
        from aec_tpu_torch.configs import TrainConfig
        from aec_tpu_torch.models.dccrn import DccrnConfig
        from aec_tpu_torch.models.tree_net import copy_into, functional_params, model_state
        from aec_tpu_torch.train.generic import make_adapter
        from aec_tpu_torch.train.loop import Optimizer, make_stateful_train_step

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        net_cfg = cfg["net"]
        want = DccrnConfig(conv_channels=tuple(net_cfg["conv_channels"]),
                           kernel=tuple(net_cfg["kernel"]), stride=tuple(net_cfg["stride"]),
                           padding=tuple(net_cfg["padding"]),
                           masking_mode=net_cfg["masking_mode"], use_clstm=net_cfg["use_clstm"],
                           use_cbn=net_cfg["use_cbn"], rnn_layers=net_cfg["rnn_layers"],
                           v2_head=net_cfg["v2_head"])
        if want != DccrnConfig():
            raise ValueError("the training adapter runs DccrnConfig(): the configuration differs")
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        self.sr = cfg["sample_rate"]
        self.n = int(round(mix["seconds"] * self.sr))
        g = scenes.generator(ctx.seed, dev)
        self.pool = []
        for _ in range(mix["pool"]):
            s = scenes.make(g, mix["batch"], self.n, mix["scene"], dev)
            self.pool.append((s["mic"], s["far"], s["near"], s["echo"]))
        params, state = self.ref.make_weights(cfg, ctx.seed, dev)
        self.init = self.ref.clone(params), self.ref.clone(state)
        adapter = make_adapter(net_cfg["family"])
        self.net = adapter.module(params, state)
        tc = TrainConfig(lr=cfg["train"]["lr"], batch_size=mix["batch"])
        self.opt = Optimizer(tc, cfg["train"]["steps_per_epoch"], self.net)

        def step_loss(p, s, mic, far, near, echo):
            loss, new_state = adapter.loss(p, s, mic, far, near, echo, True)
            return loss, {"state": new_state}

        step = make_stateful_train_step(step_loss, self.opt)
        self.state = model_state(self.net)

        def program(batch):
            new_state, loss = step(self.state, *batch)
            copy_into(self.state, new_state)
            return loss

        self.program = program
        leaves = self.ref.leaves
        self.losses = []
        for k in range(mix["check_steps"]):
            self.losses.append(float(self.program(self.pool[k])))
            if k == 0:
                moment = {id(p): self.opt.adam.state[p]["exp_avg"] for p in self.net.parameters()}
                self.grad = {path: (moment[id(p)] / (1.0 - BETA1)).clone()
                             for path, p in leaves(functional_params(self.net))}
        self.after = {path: p.detach().clone() for path, p in leaves(functional_params(self.net))}
        self.after_state = {path: t.clone() for path, t in leaves(self.state)}
        self.next = mix["check_steps"]

    def window(self, seconds: float, win) -> dict:
        end, steps, size = win.start + seconds, 0, len(self.pool)
        while True:
            with span("step"):
                loss = self.program(self.pool[(self.next + steps) % size])
            steps += 1
            if time.perf_counter() >= end:
                break
        with span("read_loss"):
            last = float(loss)
        wall = win.stop()
        batch = self.ctx.mix["batch"]
        failed = 0 if last == last else 1  # a NaN loss is a failed step
        return {"attempted": steps, "failed": failed,
                "e2e": {"train_xrt": steps * batch * self.n / self.sr / wall},
                "work": {"steps": steps, "batch": batch, "samples": self.n, "wall_s": wall}}

    def release(self) -> None:
        self.program = self.net = self.opt = None

    def check(self, control: bool = False, fault: str = "") -> dict:
        """Against the reference's Adam steps from the same weights on the
        same batches: each step's loss (relative gap); the gap between the
        norms of the first gradient by the worst leaf of at least ``LARGE``
        elements (the convs' kernels, the LSTMs' matrices and biases), of the
        parameters' change after the steps by the median leaf (Adam turns
        the round-off of a gradient element near zero into a step of lr, so
        the worst leaf's change swings from seed to seed), and of the
        BatchNorm statistics by the worst leaf; each gap against the
        reference's norm of that leaf or of the median leaf, whichever is
        larger. Leaves whose
        reference gradient is under a thousandth of the median leaf's (the
        conv biases before a BatchNorm, exact zeros that Adam moves on
        round-off) are left out of the gradient and the change. ``control``
        puts the reference in TF32 in the program's place; ``fault="half"``
        the reference on half of each batch."""
        lr = self.ctx.cfg["train"]["lr"]
        batches = self.pool[:self.ctx.mix["check_steps"]]

        def reference(precise: bool, rows=None):
            with tf32(not precise):
                b = batches if rows is None else [tuple(t[:rows] for t in x) for x in batches]
                return self.ref.train(*self.init, b, lr=lr)

        want = reference(True)
        if control or fault:
            c = reference(not control, self.ctx.mix["batch"] // 2 if fault == "half" else None)
            got = {"loss": c["loss"], "grad": c["grad"], "params": c["params"],
                   "state": c["state"]}
        else:
            got = {"loss": self.losses, "grad": self.grad, "params": self.after,
                   "state": self.after_state}
        init = dict(self.ref.leaves(self.init[0]))
        norms = {k: float(v.norm()) for k, v in want["grad"].items()}
        median = sorted(norms.values())[len(norms) // 2]
        moved = [k for k, v in norms.items() if v >= 1e-3 * median]
        large = [k for k in moved if init[k].numel() >= LARGE]
        self.detail = {"loss_steps": [abs(a - b) / abs(b) for a, b in
                                      zip(got["loss"], want["loss"])]}

        def per_leaf(get, keys):
            ref_n = {k: float(get(want, k).norm()) for k in keys}
            floor = sorted(ref_n.values())[len(ref_n) // 2]
            return {k: abs(float(get(got, k).float().norm()) - ref_n[k])
                    / max(ref_n[k], floor, 1e-30) for k in keys}

        def worst_of(name, per, keys):
            gap = 0.0
            for k in keys:
                gap = worst(gap, per[k])
            self.detail[name] = sorted(((k, per[k]) for k in keys), key=lambda kv: -kv[1])[:3]
            return gap

        out = {"loss_gap": worst(0.0, *self.detail["loss_steps"])}
        for name, get in (("grad_gap", lambda t, k: t["grad"][k]),
                          ("step_gap", lambda t, k: t["params"][k] - init[k])):
            per = per_leaf(get, moved)
            self.detail[name + "_large_leaf"] = worst_of(name + "_large", per, large)
            self.detail[name + "_every_leaf"] = worst_of(name + "_top", per, moved)
            self.detail[name + "_median_leaf"] = sorted(per.values())[len(per) // 2]
        out["grad_gap"] = self.detail["grad_gap_large_leaf"]
        out["step_gap"] = self.detail["step_gap_median_leaf"]
        state = list(want["state"])
        out["bn_gap"] = worst_of("bn_gap", per_leaf(lambda t, k: t["state"][k], state), state)
        return out
