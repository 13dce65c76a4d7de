"""FullSubNet's training steps back to back, at the configuration's widths:
``train/loop.make_stateful_train_step`` over
``train/generic.make_adapter("fullsubnet", model_cfg=...)``'s loss (drop
band on) and ``train/loop.Optimizer`` (Adam), as ``GenericTrainer`` runs
them.

Set-up makes the weights from the seed and builds one training object. It
drives that object through the first ``check_steps`` steps, on the pool's
first batches, through the window's own call; those are the steps the check
follows. The window goes on from there, one step after another on batches
of (mic, far, near, echo) from a pool on the card, and ends with the last
loss read back. ``train_xrt`` is the audio of all its steps over its wall
time.

Traffic keys: ``batch``, ``seconds`` (of an utterance), ``pool``,
``check_steps``, ``check_block`` (the reference's sub-band rows a block),
``scene``. Drop band's groups are the configuration's
(``num_groups_in_drop_band``).
"""

from __future__ import annotations

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers import train
from aec_bench.drivers.common import worst

LARGE = train.LARGE  # the least elements of a leaf the gradient gap is read on


# the published structure, the only one the program's layered form runs
STRUCTURE = {"layers": 2, "look_ahead": 2, "fb_num_neighbors": 0,
             "norm_type": "offline_laplace_norm", "num_groups_in_drop_band": 2}


def model_config(cfg: dict):
    """The program's ``FullSubNetConfig`` for the configuration's widths."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.models.fullsubnet import FullSubNetConfig

    net, st = cfg["net"], cfg["stft"]
    if any(net[k] != v for k, v in STRUCTURE.items()):
        raise ValueError(f"the program's FullSubNet takes the published structure {STRUCTURE}")
    return FullSubNetConfig(
        stft=StftConfig(win_len=st["win"], hop=st["hop"], fft_len=st["fft"]),
        fb_hidden=net["fb_model_hidden_size"], sb_hidden=net["sb_model_hidden_size"],
        neighborhood=net["sb_num_neighbors"], layered=True)


class Cell(train.Cell):
    def __init__(self, ctx):
        from aec_tpu_torch.configs import TrainConfig
        from aec_tpu_torch.models.tree_net import functional_params
        from aec_tpu_torch.train.generic import make_adapter
        from aec_tpu_torch.train.loop import Optimizer, make_stateful_train_step

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        self.sr = cfg["sample_rate"]
        self.n = int(round(mix["seconds"] * self.sr))
        g = scenes.generator(ctx.seed, dev)
        self.pool = []
        for _ in range(mix["pool"]):
            s = scenes.make(g, mix["batch"], self.n, mix["scene"], dev)
            self.pool.append((s["mic"], s["far"], s["near"], s["echo"]))
        params, _ = self.ref.make_weights(cfg, ctx.seed, dev)
        self.init = self.ref.clone(params), {}
        adapter = make_adapter("fullsubnet", model_cfg=model_config(cfg))
        self.net = adapter.module(params, {})
        tc = TrainConfig(lr=cfg["train"]["lr"], batch_size=mix["batch"])
        self.opt = Optimizer(tc, cfg["train"]["steps_per_epoch"], self.net)

        def step_loss(p, s, mic, far, near, echo):
            loss, new_state = adapter.loss(p, s, mic, far, near, echo, True)
            return loss, {"state": new_state}

        step = make_stateful_train_step(step_loss, self.opt)
        self.program = lambda batch: step({}, *batch)[1]
        self.losses = []
        for k in range(mix["check_steps"]):
            self.losses.append(float(self.program(self.pool[k])))
            if k == 0:
                moment = {id(p): self.opt.adam.state[p]["exp_avg"] for p in self.net.parameters()}
                self.grad = {path: (moment[id(p)] / (1.0 - train.BETA1)).clone()
                             for path, p in self.ref.leaves(functional_params(self.net))}
        self.after = {path: p.detach().clone()
                      for path, p in self.ref.leaves(functional_params(self.net))}
        self.next = mix["check_steps"]

    def check(self, control: bool = False, fault: str = "") -> dict:
        """Against the reference's Adam steps from the same weights on the
        same batches (its sub band in blocks of ``check_block`` rows): each
        step's loss (relative gap); the gap between the norms of the first
        gradient by the worst leaf of at least ``LARGE`` elements, and of
        the parameters' change after the steps by the median leaf, each
        against the larger of the reference's norm of that leaf and of the
        median leaf (as ``dccrn.train`` reads them; FullSubNet has no
        BatchNorm statistics). ``control`` puts the reference in TF32 in
        the program's place; ``fault="half"`` the reference on half of each
        batch."""
        lr, mix = self.ctx.cfg["train"]["lr"], self.ctx.mix
        batches = self.pool[:mix["check_steps"]]

        def reference(precise: bool, rows=None):
            b = batches if rows is None else [tuple(t[:rows] for t in x) for x in batches]
            return self.ref.train(*self.init, b, lr=lr, cfg=self.ctx.cfg,
                                  block=mix["check_block"], tf32=not precise)

        want = reference(True)
        if control or fault:
            got = reference(not control, mix["batch"] // 2 if fault == "half" else None)
        else:
            got = {"loss": self.losses, "grad": self.grad, "params": self.after}
        init = dict(self.ref.leaves(self.init[0]))
        keys = list(want["grad"])
        large = [k for k in keys if init[k].numel() >= LARGE]
        self.detail = {"loss_steps": [abs(a - b) / abs(b) for a, b in
                                      zip(got["loss"], want["loss"])]}

        def per_leaf(get, keys):
            ref_n = {k: float(get(want, k).norm()) for k in keys}
            floor = sorted(ref_n.values())[len(ref_n) // 2]
            return {k: abs(float(get(got, k).float().norm()) - ref_n[k])
                    / max(ref_n[k], floor, 1e-30) for k in keys}

        out = {"loss_gap": worst(0.0, *self.detail["loss_steps"])}
        for name, get in (("grad_gap", lambda t, k: t["grad"][k]),
                          ("step_gap", lambda t, k: t["params"][k] - init[k])):
            per = per_leaf(get, keys)
            self.detail[name + "_top"] = sorted(per.items(), key=lambda kv: -kv[1])[:3]
            self.detail[name + "_large_leaf"] = worst(0.0, *(per[k] for k in large))
            self.detail[name + "_median_leaf"] = sorted(per.values())[len(per) // 2]
        out["grad_gap"] = self.detail["grad_gap_large_leaf"]
        out["step_gap"] = self.detail["step_gap_median_leaf"]
        return out
