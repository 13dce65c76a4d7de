"""Each plain reference against the port's plain route at tiny sizes on the
CPU, and the references' independence from the program."""

from __future__ import annotations

import ast
import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from aec_bench import scenes
from aec_bench.reference import dccrn as ref_dccrn
from aec_bench.reference import dsp
from aec_bench.reference import littlenet_kalman as ref_ln
from aec_bench.tests.helpers import REPO

LN = json.loads((REPO / "aec_bench" / "configs" / "littlenet_kalman.json").read_text())
DC = json.loads((REPO / "aec_bench" / "configs" / "dccrn.json").read_text())
MIX = json.loads((REPO / "aec_bench" / "traffic" / "bulk.json").read_text())["scene"]
WEIGHTS = str(REPO / LN["weights"])
NARROW = (4, 8, 16)


def scene(rows=3, n=4096, seed=5):
    return scenes.make(scenes.generator(seed, "cpu"), rows, n, MIX, "cpu")


def erb():
    return torch.as_tensor(dsp.erb_matrix().astype(np.float32))


def test_erb_matrix_is_the_ports():
    from aec_tpu_torch.dsp.erb import erb_filterbank

    assert np.array_equal(dsp.erb_matrix().astype(np.float32), erb_filterbank())


def test_stft_pair_is_the_ports():
    from aec_tpu_torch.dsp import stft as port

    x = scene()["mic"]
    spec = dsp.stft(x)
    assert torch.allclose(spec, port.stft(x, port.StftConfig()), atol=1e-4)
    assert torch.allclose(dsp.istft(spec), port.istft(spec, port.StftConfig()), atol=1e-5)


def test_kalman_is_the_ports_plain_loop():
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.linear.kalman import kalman_cancel_plain

    s = scene()
    got = dsp.kalman_cancel(LN["kalman"], s["far"], s["mic"], 256)
    want = kalman_cancel_plain(KalmanConfig(**LN["kalman"]), s["far"], s["mic"], block=256)["wav"]
    assert (got - want).abs().max() <= 1e-5 * s["mic"].abs().max()


def test_littlenet_is_the_ports():
    from aec_tpu_torch.models.little_net import little_net_apply
    from aec_tpu_torch.utils.weights import load_npz

    s = scene()
    got = ref_ln.littlenet(ref_ln.load_weights(WEIGHTS, "cpu"), s["mic"], s["far"], erb(), 512, 256)
    want = little_net_apply(load_npz(WEIGHTS, device="cpu"), s["mic"], s["far"], erb(),
                            normalize=False)["wav"]
    assert (got - want).abs().max() <= 1e-5 * s["mic"].abs().max()


def test_stream_is_the_ports_serving_plain_version():
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_plain
    from aec_tpu_torch.utils.weights import load_npz

    s = scene(rows=3, n=256 * 24)
    net = load_npz(WEIGHTS, device="cpu")
    state = serving_init(3, device="cpu")
    stream = ref_ln.Stream(LN, ref_ln.load_weights(WEIGHTS, "cpu"), erb(), 3, "cpu")
    for t in range(24):
        blk = slice(t * 256, (t + 1) * 256)
        state, out = serving_step_plain(net, state, s["far"][:, blk].contiguous(),
                                        s["mic"][:, blk].contiguous(), erb(),
                                        KalmanConfig(**LN["kalman"]))
        mine = stream.step(s["far"][:, blk], s["mic"][:, blk])
        assert (out - mine).abs().max() <= 1e-5 * s["mic"].abs().max()
    ours = stream.state()
    theirs = dict({k: state[k] for k in ("wr", "wi", "p", "psi", "h", "tail")},
                  mon_mic=state["nm"][:, 5], mon_lin=state["nm"][:, 6])
    for k, v in ours.items():
        assert (theirs[k] - v).abs().max() <= 1e-4 * v.abs().max().clamp_min(1e-12), k


def narrow_cfg():
    cfg = copy.deepcopy(DC)
    cfg["net"]["conv_channels"] = list(NARROW)
    return cfg


def port_cfg():
    from aec_tpu_torch.models.dccrn import DccrnConfig

    return DccrnConfig(conv_channels=NARROW)


def test_weights_have_the_ports_layout():
    from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_init

    for cfg, pc in ((DC, DccrnConfig()), (narrow_cfg(), port_cfg())):
        p, s = ref_dccrn.make_weights(cfg, 3, "cpu")
        pp, ss = dccrn_init(pc, generator=torch.Generator().manual_seed(0), device="cpu")
        for mine, theirs in ((p, pp), (s, ss)):
            a, b = dict(ref_dccrn.leaves(mine)), dict(ref_dccrn.leaves(theirs))
            assert a.keys() == b.keys()
            assert all(a[k].shape == b[k].shape for k in a)


def test_dccrn_forward_is_the_ports():
    from aec_tpu_torch.models.dccrn import dccrn_apply

    s = scene(rows=2, n=256 * 40)
    p, st = ref_dccrn.make_weights(narrow_cfg(), 4, "cpu")
    with torch.no_grad():
        got = ref_dccrn.forward(p, st, s["mic"], s["far"], train=False)[0]
        want = dccrn_apply(p, st, s["mic"], s["far"], port_cfg(), train=False)[0]["wav"]
    assert (got - want).abs().max() <= 1e-5 * s["mic"].abs().max()


def test_dccrn_train_steps_are_the_ports():
    """Two Adam steps of the v1 loss: losses, the first gradient, the
    parameters and the BatchNorm statistics after."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.models.dccrn import Dccrn, dccrn_loss_v1
    from aec_tpu_torch.models.tree_net import copy_into, functional_params, model_state
    from aec_tpu_torch.train.loop import Optimizer, make_stateful_train_step

    batches = [tuple(scene(rows=2, n=256 * 24, seed=k)[key] for key in
                     ("mic", "far", "near", "echo")) for k in (1, 2)]
    p, st = ref_dccrn.make_weights(narrow_cfg(), 6, "cpu")
    want = ref_dccrn.train(p, st, batches, lr=1e-3)
    net = Dccrn(ref_dccrn.clone(p), ref_dccrn.clone(st), port_cfg())
    opt = Optimizer(TrainConfig(lr=1e-3), 1000, net)

    def loss_fn(params, state, mic, far, near, echo):
        loss, aux = dccrn_loss_v1(params, state, mic, far, near, echo, port_cfg())
        return loss, {"state": aux["state"]}

    step = make_stateful_train_step(loss_fn, opt)
    state = model_state(net)
    losses = []
    for b in batches:
        new, loss = step(state, *b)
        copy_into(state, new)
        losses.append(float(loss))
        if len(losses) == 1:
            grad = {k: opt.adam.state[v]["exp_avg"] / 0.1
                    for k, v in ref_dccrn.leaves(functional_params(net))}
    assert np.allclose(losses, want["loss"], rtol=1e-5)
    # the conv biases before a BatchNorm have an exact-zero gradient, computed
    # as round-off: held to the largest leaf's scale, their Adam steps left out
    norms = {k: float(g.norm()) for k, g in want["grad"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    top = max(float(g.abs().max()) for g in want["grad"].values())
    for k, g in want["grad"].items():
        scale = g.abs().max() if norms[k] >= 1e-3 * median else top
        assert (grad[k] - g).abs().max() <= 1e-3 * scale, k
    for k, v in ref_dccrn.leaves(functional_params(net)):
        if norms[k] >= 1e-3 * median:  # Adam turns round-off near g = 0 into steps of lr
            assert (v.detach() - want["params"][k]).abs().mean() <= 1e-3 * 1e-3, k
    # a running mean follows the conv bias before it, whose round-off steps
    # of +-lr move it by up to 0.1 lr a step
    for k, v in ref_dccrn.leaves(state):
        atol = 0.1 * 1e-3 * len(batches) if "'m_" in k else 1e-6
        assert torch.allclose(v, want["state"][k], rtol=1e-4, atol=atol), k


def test_enhance_is_the_ports_infer_route(tmp_path):
    from aec_tpu_torch.cli.infer import _make_enhancer
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.train import checkpoints

    s = scene(rows=1, n=256 * 32)
    p, st = ref_dccrn.make_weights(DC, 8, "cpu")
    path = str(tmp_path / "m.npz")
    checkpoints.save(path, {"params": p, "model_state": st})
    enhance, _ = _make_enhancer("dccrn", path, "kalman", StftConfig(), device="cpu")
    want = enhance(s["far"], s["mic"])
    got = ref_dccrn.enhance(p, st, DC["kalman"], s["far"], s["mic"])
    assert (got - want).abs().max() <= 1e-5 * s["mic"].abs().max()


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "aec_bench" / "reference")
                                        .glob("*.py")))
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((REPO / "aec_bench" / "reference" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for m in mods:
            assert m.split(".")[0] not in ("aec_tpu_torch", "aec_tpu", "jax", "jaxlib", "flax"), m
    code = (f"import sys; sys.modules['aec_tpu_torch'] = None; sys.modules['jax'] = None; "
            f"import aec_bench.reference.{name}")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
