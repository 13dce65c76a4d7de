"""Port ATT-CCRN (aec_tpu_torch.models.att_ccrn, the int8 bottleneck route, the
weight carry) == JAX, on the same numpy inputs and JAX's weights carried over.

``channels=(1, 4, 8)`` gives a 2 x 8 x 64 = 1024-wide bottleneck LSTM, 128
aligned as JAX's int8 kernel wants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.models import att_ccrn as ja
from aec_tpu_torch.kernels import lstm_int8 as k10
from aec_tpu_torch.models import att_ccrn as ta
from aec_tpu_torch.utils.weights import att_ccrn_from_jax, att_ccrn_to_jax

CH = (1, 4, 8)
# fp32 round-off of convolutions, BatchNorm, STFT products and a recurrence
# in another summation order, relative to each output's scale
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-9)
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} x {scale:.3e}"


@pytest.fixture(scope="module")
def case():
    """JAX's init at CH with the BatchNorm statistics and PReLU slopes moved
    off their defaults (so the eval path exercises them), the port's module
    carrying the same trees, and 2 x 2048-sample inputs."""
    rng = np.random.default_rng(11)
    cfg_j, cfg_t = ja.AttCcrnConfig(channels=CH), ta.AttCcrnConfig(channels=CH)
    params, state = jax.tree.map(np.asarray, ja.att_ccrn_init(jax.random.PRNGKey(0), cfg_j))

    def jitter(path, v):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return v * (1.0 + 0.5 * rng.random(v.shape).astype(np.float32))
        if "'mean'" in name or "prelu" in name or "'scale'" in name:
            return v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(jitter, params)
    state = jax.tree_util.tree_map_with_path(jitter, state)
    net = att_ccrn_from_jax(params, state, cfg_t, device="cpu")
    mic, far, near = (rng.standard_normal((2, 2048)).astype(np.float32) for _ in range(3))
    return cfg_j, cfg_t, params, state, net, mic, far, near


def test_weights_round_trip_and_init_shapes(case):
    cfg_j, cfg_t, params, state, net, *_ = case
    p_back, s_back = att_ccrn_to_jax(net)
    for got, want in zip(jax.tree_util.tree_leaves((p_back, s_back)),
                         jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(got, np.asarray(want))
    fresh = ta.att_ccrn_init(cfg_t, generator=torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda v: tuple(v.shape), fresh)
            == jax.tree.map(np.shape, (params, state)))
    assert ta.bottleneck_features(cfg_t) == 1024
    assert ta.bottleneck_features(ta.AttCcrnConfig()) == 4096


@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_jax(case, train):
    """Eval forward (wav, masks, spectrum) and, in train mode, the batch
    statistics the BatchNorms carry out, at fp32 round-off."""
    cfg_j, cfg_t, params, state, net, mic, far, _ = case
    oj, sj = ja.att_ccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j,
                               train=train)
    with torch.no_grad():
        ot, st = ta.att_ccrn_apply(net.params(), net.state(), torch.from_numpy(mic),
                                   torch.from_numpy(far), cfg_t, train=train)
    for k in ("wav", "mask_re", "mask_im", "out_spec"):
        _close(ot[k], oj[k], what=k)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(sj),
                            jax.tree_util.tree_leaves(st)):
        _close(g, w, what=jax.tree_util.keystr(path))


def test_int8_route_matches_jax(case):
    """``lstm_recurrent_dtype="int8"`` on both sides: exact integer sums, the
    fp32 projections' round-off may move one code of h by one: 1e-2 of the
    wav's scale. It is a different computation from f32 (the cast did
    something), and a CPU tensor never launches K10."""
    cfg_j, cfg_t, params, state, net, mic, far, _ = case
    oj, _ = ja.att_ccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j,
                              lstm_recurrent_dtype="int8")
    before = k10.lstm_int8_recurrence.launches
    with torch.no_grad():
        ot, _ = ta.att_ccrn_apply(net.params(), net.state(), torch.from_numpy(mic),
                                  torch.from_numpy(far), cfg_t, lstm_recurrent_dtype="int8")
        of, _ = ta.att_ccrn_apply(net.params(), net.state(), torch.from_numpy(mic),
                                  torch.from_numpy(far), cfg_t)
    assert k10.lstm_int8_recurrence.launches == before
    _close(ot["wav"], oj["wav"], 1e-2, "int8 wav")
    assert float((ot["wav"] - of["wav"]).abs().max()) > 0


def test_loss_matches_jax(case):
    cfg_j, cfg_t, params, state, net, mic, far, near = case
    lj, aux_j = ja.att_ccrn_loss(params, state, *map(jnp.asarray, (mic, far, near)), cfg_j)
    lt, aux_t = ta.att_ccrn_loss(net.params(), net.state(),
                                 *map(torch.from_numpy, (mic, far, near)), cfg_t)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    _close(aux_t["wav"], aux_j["wav"], what="wav")


def test_module_forward_and_mesh_refusal(case):
    """The module's eval forward is ``att_ccrn_apply``; train mode writes the
    new statistics into its buffers. ``lstm_mesh`` (the tensor-parallel
    bottleneck) raises naming ROADMAP A6."""
    cfg_j, cfg_t, params, state, net, mic, far, _ = case
    m, f = torch.from_numpy(mic), torch.from_numpy(far)
    with torch.no_grad():
        out = net(m, f)
        want, _ = ta.att_ccrn_apply(net.params(), net.state(), m, f, cfg_t)
    assert torch.equal(out["wav"], want["wav"])
    train_net = att_ccrn_from_jax(params, state, cfg_t, device="cpu").train()
    with torch.no_grad():
        train_net(m, f)
    _, sj = ja.att_ccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j,
                              train=True)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(sj),
                            jax.tree_util.tree_leaves(train_net.state())):
        _close(g, w, what=jax.tree_util.keystr(path))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        ta.att_ccrn_apply(net.params(), net.state(), m, f, cfg_t, lstm_mesh=object())
