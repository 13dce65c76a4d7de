"""The port's data-parallel steps (parallel/mesh, parallel/global_batch,
train/loop's make_train_step / make_stateful_train_step with a mesh) on 2
and 4 gloo ranks == JAX's step on the whole batch, with JAX's bars
(tests/test_parallel.py, tests/test_distributed.py) and the summed
gradient against JAX's gradient of the whole batch's loss; a per-rank
control (each rank's own pseudo-norm or BatchNorm statistics, DDP's mean
gradients, or BatchNorm statistics whose all-reduce has no backward) must
miss them.

The ranks start once per world size for the file (module fixture), one
intra-op thread each, the workers in tests/torch_parallel_ranks.py.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models import dccrn as jdccrn
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.little_net import little_net_loss as jax_loss
from aec_tpu.train import loop as jloop
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models import dccrn as tdccrn
from aec_tpu_torch.models.little_net import little_net_loss
from aec_tpu_torch.models.tree_net import bias_keys_before_batch_norm, model_state
from aec_tpu_torch.parallel import mesh as tmesh
from aec_tpu_torch.parallel.dryrun import run_ranks
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.utils import weights

import torch_parallel_ranks as ranks

LR = ranks.LR
B, N = 8, 4096
NARROW = {"conv_channels": (4, 8, 16)}
SPAWN_S = 240  # each world's ranks, start to finish


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(_np_tree(tree))[0]]


def _scene(rng):
    """Echo scenes whose utterances differ in level and offset, so that a
    rank's pseudo-norm (one mean/std over its rows) is not the batch's."""
    far = rng.standard_normal((B, N)).astype(np.float32)
    rir = (np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
    echo = np.stack([np.convolve(f, 0.3 * rir)[:N] for f in far]).astype(np.float32)
    near = (0.2 * rng.standard_normal((B, N))).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, (B, 1)).astype(np.float32)
    offset = rng.uniform(-0.3, 0.3, (B, 1)).astype(np.float32)
    return ((gain * (near + echo) + offset).astype(np.float32), (gain * far).astype(np.float32),
            (gain * near).astype(np.float32), (gain * echo).astype(np.float32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    mic, far, near, echo = _scene(rng)
    params = _np_tree(jax_init(jax.random.PRNGKey(0)))
    dparams, dstate = jdccrn.dccrn_init(jax.random.PRNGKey(1), jdccrn.DccrnConfig(**NARROW))
    job = {"mic": mic, "ref": far, "near": near, "erb": erb_filterbank().astype(np.float32),
           "little": params, "dccrn": (_np_tree(dparams), _np_tree(dstate)),
           "dccrn_cfg": NARROW, "batch": (mic, far, near, echo)}
    return job


@pytest.fixture(scope="module")
def jax_steps(case):
    """JAX's steps on the whole batch: each net's gradient, loss and
    parameters, and DCCRN's new BatchNorm statistics."""
    opt = jloop.make_optimizer(JaxTrainConfig(lr=LR), 100)
    args = [jnp.asarray(case[k]) for k in ("mic", "ref", "near", "erb")]
    grads = jax.jit(jax.grad(lambda p: jax_loss(p, *args, sqrt_eps=1e-12)[0]))(case["little"])
    params, _, loss = jloop.make_train_step(jax_loss, opt)(
        case["little"], opt.init(case["little"]), *args)
    cfg = jdccrn.DccrnConfig(**NARROW)
    dparams, dstate = case["dccrn"]
    dbatch = list(map(jnp.asarray, case["batch"]))

    def dloss_fn(p, s, *b):
        return jdccrn.dccrn_loss_v1(p, s, *b, cfg, train=True)

    dgrads = jax.jit(jax.grad(lambda p: dloss_fn(p, dstate, *dbatch)[0]))(dparams)
    dparams, _, dstate, dloss = jloop.make_stateful_train_step(dloss_fn, opt)(
        dparams, opt.init(dparams), dstate, *dbatch)
    return {"little": {"loss": float(loss), "grads": _np_tree(grads), "params": _np_tree(params)},
            "dccrn": {"loss": float(dloss), "grads": _np_tree(dgrads), "params": _np_tree(dparams),
                      "state": _np_tree(dstate)}}


@pytest.fixture(scope="module")
def port_steps(case):
    """The port's unsharded steps on the whole batch, from the same weights."""
    net = weights.params_from_jax(case["little"], device="cpu")
    opt = tloop.make_optimizer(TrainConfig(lr=LR), 100, net)
    batch = [torch.from_numpy(case[k]) for k in ("mic", "ref", "near", "erb")]
    loss = tloop.make_train_step(little_net_loss, opt)(*batch)
    cfg = tdccrn.DccrnConfig(**NARROW)
    dnet = weights.dccrn_from_jax(*case["dccrn"], cfg, device="cpu")
    dopt = tloop.make_optimizer(TrainConfig(lr=LR), 100, dnet)
    state, dloss = tloop.make_stateful_train_step(
        lambda p, s, *b: tdccrn.dccrn_loss_v1(p, s, *b, cfg, train=True), dopt)(
        model_state(dnet), *map(torch.from_numpy, case["batch"]))
    return {"little": {"loss": float(loss), "params": weights.params_to_jax(net),
                       "grads": weights.param_tree(net, lambda p: p.grad.numpy())},
            "dccrn": {"loss": float(dloss), "params": weights.to_jax(dnet)[0],
                      "grads": weights.param_tree(dnet, lambda p: p.grad.numpy()),
                      "state": jax.tree.map(lambda v: v.numpy(), state)}}


@pytest.fixture(scope="module")
def runs(case):
    """Both worlds' ranks, started at once."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {world: pool.submit(run_ranks, ranks.steps_worker, world, (case,),
                                  timeout=SPAWN_S) for world in (2, 4)}


@pytest.fixture(scope="module")
def ranks_out(runs, jax_steps, port_steps):
    """Each world's ranks' results (the references computed meanwhile)."""
    return {world: run.result() for world, run in runs.items()}


def _grad_missed(got, want) -> list[str]:
    """The summed gradient within 1e-4 of each leaf's scale (the global
    gradient, not DDP's mean, and with the cotangents of the global
    statistics summed over the ranks). A bias that feeds a BatchNorm has an
    exact zero gradient, computed as round-off in both packages
    (tests/test_torch_zoo_train.py::test_pre_batchnorm_biases_have_round_off_gradients):
    its bar is 1e-5 of the tree's largest leaf, as there. The names of the
    leaves missed."""
    zeros = {jax.tree_util.keystr(p) for p in bias_keys_before_batch_norm(want)}
    pairs = list(zip(_leaves(got), _leaves(want)))
    top = max(np.abs(w).max() for _, (_, w) in pairs)
    missed = []
    for (path, g), (_, w) in pairs:
        scale = 1e-5 * top if path in zeros else 1e-4 * np.abs(w).max()
        if np.abs(g - w).max() > scale:
            missed.append(f"grad {path} {np.abs(g - w).max() / np.abs(w).max():.2e}")
    return missed


def _little_bars(got: dict, want: dict) -> list[str]:
    """JAX's bars for the LittleNet step (tests/test_parallel.py): loss rtol
    1e-5, every parameter within 3 lr; and the gradient's bar
    (_grad_missed). The names of the bars missed."""
    missed = []
    if not np.isclose(got["loss"], want["loss"], rtol=1e-5, atol=0):
        missed.append(f"loss {got['loss']} vs {want['loss']}")
    for (path, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        if np.abs(g - w).max() > 3 * LR:
            missed.append(f"param {path} {np.abs(g - w).max():.2e}")
    return missed + _grad_missed(got["grads"], want["grads"])


def _state_missed(got, want) -> list[str]:
    """Each new BatchNorm statistic within 1e-5 of its BatchNorm's scale
    (the largest of that BatchNorm's statistics; tests/test_torch_zoo_train
    says why)."""
    flat = [(p, np.asarray(w), np.asarray(g)) for (p, w), g in zip(
        jax.tree_util.tree_flatten_with_path(_np_tree(want))[0], jax.tree.leaves(got))]
    scale: dict = {}
    for p, w, _ in flat:
        bn = jax.tree_util.keystr(p[:-1])
        scale[bn] = max(scale.get(bn, 1e-12), float(np.abs(w).max()))
    return [f"{jax.tree_util.keystr(p)} {np.abs(g - w).max():.2e}" for p, w, g in flat
            if np.abs(g - w).max() > 1e-5 * scale[jax.tree_util.keystr(p[:-1])]]


def _dccrn_bars(got: dict, want: dict) -> list[str]:
    """The LittleNet step's bars and each new BatchNorm statistic's."""
    return _little_bars(got, want) + _state_missed(got["state"], want["state"])


def test_single_process_mesh_is_one_by_one(monkeypatch):
    """Without a coordinator distributed_init_if_needed is a no-op, and
    make_mesh gives JAX's one-device mesh: 1 x 1, no process group, this
    process primary, every file its own."""
    for var in ("AEC_COORDINATOR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.distributed_init_if_needed(device="cpu") is False
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.group("data") is None
    assert tmesh.is_primary() and tmesh.process_local_files([1, 2, 3]) == [1, 2, 3]
    assert tmesh.local_rows(m, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.make_mesh(2)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_come_up_from_the_environment(ranks_out, world):
    """AEC_COORDINATOR / AEC_NUM_PROCESSES / AEC_PROCESS_ID bring up a gloo
    group (a second call is a no-op); a cross-rank sum sees every rank; the
    data axis spans the ranks in rank order."""
    out = ranks_out[world]
    for r, o in enumerate(out):
        assert o["init"] is True and o["again"] is False and o["backend"] == "gloo"
        assert o["sum"] == world * (world + 1) / 2
        assert o["shape"] == {"data": world, "model": 1} and o["index"] == r


@pytest.mark.parametrize("world", [2, 4])
def test_little_net_step_is_jax_global_step(ranks_out, jax_steps, port_steps, world):
    """make_train_step(mesh=...) on B = 8 x 4096 split over the ranks ==
    JAX's make_train_step on the whole batch and the port's unsharded step
    (_little_bars), every rank reporting the same loss."""
    out = [o["little"]["global"] for o in ranks_out[world]]
    assert len({o["loss"] for o in out}) == 1
    for o in out:
        assert _little_bars(o, jax_steps["little"]) == []
        assert _little_bars(o, port_steps["little"]) == []


@pytest.mark.parametrize("world", [2, 4])
def test_ddp_style_control_misses_the_bars(ranks_out, jax_steps, world):
    """Each rank's own pseudo-norm and DDP's mean gradients (the loss summed
    over the ranks) miss the bars the global step meets."""
    for o in ranks_out[world]:
        missed = _little_bars(o["little"]["control"], jax_steps["little"])
        assert any(m.startswith("loss") for m in missed), missed
        assert any(m.startswith("grad") for m in missed), missed


@pytest.mark.parametrize("world", [2, 4])
def test_stateful_dccrn_step_is_the_global_step(ranks_out, jax_steps, port_steps, world):
    """make_stateful_train_step(mesh=...) of the narrow DCCRN (complex
    whitening BatchNorm) on B = 8 split over the ranks == the port's
    unsharded step and JAX's on the whole batch: loss rtol 1e-5, parameters
    within 3 lr, the summed gradient within 1e-4 of each leaf's scale (the
    gradient through the global BatchNorm statistics), each new BatchNorm
    statistic within 1e-5 of its BatchNorm's scale, the same on every
    rank."""
    out = [o["dccrn"]["global"] for o in ranks_out[world]]
    assert len({o["loss"] for o in out}) == 1
    for o in out:
        assert _dccrn_bars(o, port_steps["dccrn"]) == []
        assert _dccrn_bars(o, jax_steps["dccrn"]) == []


@pytest.mark.parametrize("world", [2, 4])
def test_per_rank_batch_norm_control_misses_the_bars(ranks_out, port_steps, world):
    """With each rank's own BatchNorm statistics and DCCRN's loss means
    (DDP's mean gradients) the new statistics and the gradient miss their
    bars."""
    for o in ranks_out[world]:
        missed = _dccrn_bars(o["dccrn"]["control"], port_steps["dccrn"])
        assert any(m.startswith("grad") for m in missed), missed
        assert _state_missed(o["dccrn"]["control"]["state"], port_steps["dccrn"]["state"])


@pytest.mark.parametrize("world", [2, 4])
def test_batch_norm_all_reduce_without_backward_misses_the_gradient_bar(
        ranks_out, jax_steps, port_steps, world):
    """The global step whose BatchNorm all-reduce keeps each rank's own
    cotangent (no all-reduce in its backward) has the global forward (loss
    and statistics on their bars) and misses the gradient's bar against the
    port's unsharded step and JAX's: the bar sees the backward of the
    statistics' all-reduce."""
    for o in ranks_out[world]:
        got = o["dccrn"]["detached"]
        for want in (port_steps["dccrn"], jax_steps["dccrn"]):
            missed = _dccrn_bars(got, want)
            assert missed and all(m.startswith(("grad", "param")) for m in missed), missed
            assert any(m.startswith("grad") for m in missed), missed
