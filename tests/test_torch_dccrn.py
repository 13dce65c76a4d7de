"""Port DCCRN (aec_tpu_torch.ops.complex_layers, models.dccrn, the registry,
the adapters and the weight carry) == JAX, on the same numpy inputs and the
same weights (JAX's init, carried over)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.models import dccrn as jd
from aec_tpu.ops import complex_layers as jcl
from aec_tpu.train.generic import make_adapter as jax_make_adapter
from aec_tpu_torch.models import dccrn as td
from aec_tpu_torch.models import registry
from aec_tpu_torch.ops import complex_layers as tcl
from aec_tpu_torch.train.generic import make_adapter
from aec_tpu_torch.utils.weights import dccrn_from_jax, dccrn_to_jax

# fp32 round-off of convolutions, STFT products and a recurrence in another
# summation order, relative to each output's scale
REL = 1e-5


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} x {scale:.3e}"


def _trees_close(got, want, rel=REL):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        _close(g, w, rel, jax.tree_util.keystr(path))


# ---------------------------------------------------------------- complex layers

def test_complex_conv_matches_jax(rng):
    params = jcl.complex_conv_init(jax.random.PRNGKey(0), 4, 8, (5, 1))
    params = dict(params, b_r=params["b_r"] + 0.1, b_i=params["b_i"] - 0.2)
    x = rng.standard_normal((2, 16, 10, 4)).astype(np.float32)
    for stride, pad in (((2, 1), [(2, 2), (0, 0)]), ((1, 1), [(1, 3), (0, 1)])):
        want = jcl.complex_conv(params, jnp.asarray(x), stride, pad)
        got = tcl.complex_conv(_t(params), torch.from_numpy(x), stride, pad)
        _close(got, want, what=f"conv {stride} {pad}")


def test_complex_conv_transpose_matches_jax(rng):
    params = jcl.complex_conv_init(jax.random.PRNGKey(1), 8, 4, (5, 1))
    params = dict(params, b_r=params["b_r"] + 0.3)
    x = rng.standard_normal((2, 8, 10, 8)).astype(np.float32)
    want = jcl.complex_conv_transpose(params, jnp.asarray(x), (2, 1), (2, 0), (1, 0))
    got = tcl.complex_conv_transpose(_t(params), torch.from_numpy(x), (2, 1), (2, 0), (1, 0))
    assert tuple(got.shape) == (2, 16, 10, 4)
    _close(got, want)


def test_complex_cat_prelu_match_jax(rng):
    a = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    b = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tcl.complex_cat([torch.from_numpy(a), torch.from_numpy(b)]).numpy(),
        np.asarray(jcl.complex_cat([jnp.asarray(a), jnp.asarray(b)])))
    np.testing.assert_array_equal(
        tcl.prelu(tcl.prelu_init(device="cpu"), torch.from_numpy(a)).numpy(),
        np.asarray(jcl.prelu(jcl.prelu_init(), jnp.asarray(a))))


@pytest.mark.parametrize("train", [False, True])
def test_batch_norms_match_jax(rng, train):
    x = (2.0 * rng.standard_normal((3, 8, 5, 6)) + 0.5).astype(np.float32)
    p, s = jcl.batch_norm_init(6)
    p = dict(p, scale=p["scale"] * 1.5, bias=p["bias"] + 0.25)
    s = dict(s, mean=s["mean"] + 0.1, var=s["var"] * 2.0)
    yj, sj = jcl.batch_norm(p, s, jnp.asarray(x), train=train)
    yt, st = tcl.batch_norm(_t(p), _t(s), torch.from_numpy(x), train=train)
    _close(yt, yj)
    _trees_close(st, sj)
    cp, cs = jcl.complex_batch_norm_init(jax.random.PRNGKey(2), 6)
    cs = dict(cs, m_r=cs["m_r"] + 0.2, v_ri=cs["v_ri"] + 0.1)
    yj, sj = jcl.complex_batch_norm(cp, cs, jnp.asarray(x), train=train)
    yt, st = tcl.complex_batch_norm(_t(cp), _t(cs), torch.from_numpy(x), train=train)
    _close(yt, yj)
    _trees_close(st, sj)


def test_layer_inits_match_jax_structure():
    g = torch.Generator().manual_seed(0)
    cp, cs = tcl.complex_batch_norm_init(8, generator=g, device="cpu")
    jp, js = jcl.complex_batch_norm_init(jax.random.PRNGKey(0), 8)
    assert jax.tree.map(np.shape, _np(cp)) == jax.tree.map(np.shape, jp)
    assert jax.tree.map(np.shape, _np(cs)) == jax.tree.map(np.shape, js)
    assert float(cp["w_ri"].abs().max()) <= 0.9
    conv = tcl.complex_conv_init(4, 8, (5, 1), generator=g, device="cpu")
    assert {k: tuple(v.shape) for k, v in conv.items()} == {
        k: v.shape for k, v in jcl.complex_conv_init(jax.random.PRNGKey(0), 4, 8, (5, 1)).items()}


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


# ---------------------------------------------------------------- the model

NARROW = dict(conv_channels=(4, 8, 16), rnn_layers=1)
CONFIGS = {
    "E": {}, "C": dict(masking_mode="C"), "R": dict(masking_mode="R"),
    "v1_head": dict(v2_head=False), "lstm": dict(use_clstm=False), "real_bn": dict(use_cbn=False),
}


def _cfgs(**kw):
    return jd.DccrnConfig(**kw), td.DccrnConfig(**kw)


def _inputs(rng, b, n):
    return (rng.standard_normal((b, n)).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dccrn_apply_narrow_configs_match_jax(rng, name):
    """Every branch of DccrnConfig at narrow widths, eval and train mode:
    the outputs and the new BatchNorm state."""
    cfg_j, cfg_t = _cfgs(**NARROW, **CONFIGS[name])
    params, state = jd.dccrn_init(jax.random.PRNGKey(3), cfg_j)
    mic, far, _, _ = _inputs(rng, 2, 4096)
    for train in (False, True):
        oj, sj = jd.dccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j,
                                train=train)
        ot, st = td.dccrn_apply(_t(params), _t(state), torch.from_numpy(mic),
                                torch.from_numpy(far), cfg_t, train=train)
        for k in ("wav", "mask_re", "mask_im", "out_spec"):
            _close(ot[k], oj[k], what=f"{name} train={train} {k}")
        _trees_close(st, sj)


def _full_width_weights(seed):
    """DccrnConfig()'s trees from the port's init (JAX's own init of 33.6 M
    LSTM weights takes longer than the test), as (jax, torch) trees."""
    pt, st = td.dccrn_init(td.DccrnConfig(), generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    to_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return (jax.tree.map(to_j, pt), jax.tree.map(to_j, st)), (pt, st)


def test_dccrn_apply_full_width_matches_jax(rng):
    """DccrnConfig() (v2 end to end: two complex LSTMs at I = H = 1024 per
    part) at n = 4096, the size tests/test_dccrn.py runs it at."""
    cfg_j, cfg_t = jd.DccrnConfig(), td.DccrnConfig()
    (params, state), (pt, st) = _full_width_weights(4)
    mic, far, _, _ = _inputs(rng, 1, 4096)
    oj, _ = jax.jit(functools.partial(jd.dccrn_apply, cfg=cfg_j))(
        params, state, jnp.asarray(mic), jnp.asarray(far))
    with torch.no_grad():
        ot, _ = td.dccrn_apply(pt, st, torch.from_numpy(mic), torch.from_numpy(far), cfg_t)
    assert tuple(ot["mask_re"].shape) == (1, 257, 4096 // 256 + 1)
    for k in ("wav", "mask_re", "mask_im"):
        _close(ot[k], oj[k], what=k)


@pytest.mark.parametrize("cfg_kw", [dict(NARROW), dict(NARROW, use_clstm=False, masking_mode="C")])
def test_dccrn_losses_match_jax(rng, cfg_kw):
    """Both losses and their new state; the v1 loss's cIRM divides by
    |mic|^2 + 1e-9, which amplifies fp32 round-off on quiet bins, so it gets
    1e-4 relative (two fp32 implementations drift up to ~5e-5)."""
    cfg_j, cfg_t = _cfgs(**cfg_kw)
    params, state = jd.dccrn_init(jax.random.PRNGKey(5), cfg_j)
    mic, far, near, echo = _inputs(rng, 2, 4096)
    lj, aj = jd.dccrn_loss_v1(params, state, *map(jnp.asarray, (mic, far, near, echo)), cfg_j)
    lt, at = td.dccrn_loss_v1(_t(params), _t(state),
                              *map(torch.from_numpy, (mic, far, near, echo)), cfg_t)
    _close(lt, lj, 1e-4, "v1 loss")
    _trees_close(at["state"], aj["state"])
    lj, _ = jd.dccrn_loss_sisnr(params, state, *map(jnp.asarray, (mic, far, near)), cfg_j)
    lt, _ = td.dccrn_loss_sisnr(_t(params), _t(state), *map(torch.from_numpy, (mic, far, near)),
                                cfg_t)
    _close(lt, lj, 1e-4, "sisnr loss")


def test_dccrn_init_structure_matches_jax():
    for kw in (dict(NARROW), dict(NARROW, use_clstm=False, use_cbn=False, v2_head=False)):
        cfg_j, cfg_t = _cfgs(**kw)
        pj, sj = jd.dccrn_init(jax.random.PRNGKey(0), cfg_j)
        pt, st = td.dccrn_init(cfg_t, generator=torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.map(np.shape, _np(pt)) == jax.tree.map(np.shape, pj)
        assert jax.tree.map(np.shape, _np(st)) == jax.tree.map(np.shape, sj)


def test_module_weights_round_trip_and_forward(rng):
    """JAX trees -> ``Dccrn`` -> JAX trees bit for bit; the module's eval
    forward is dccrn_apply, its train forward writes the new statistics
    into the buffers."""
    cfg_j, cfg_t = _cfgs(**NARROW)
    params, state = jd.dccrn_init(jax.random.PRNGKey(6), cfg_j)
    net = dccrn_from_jax(params, state, cfg_t, device="cpu")
    p2, s2 = dccrn_to_jax(net)
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves((p2, s2)), leaves((params, state))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sum(p.numel() for p in net.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(params))
    mic, far, _, _ = _inputs(rng, 2, 4096)
    with torch.no_grad():
        out = net(torch.from_numpy(mic), torch.from_numpy(far))
    oj, _ = jd.dccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j)
    _close(out["wav"], oj["wav"])
    net.train()
    with torch.no_grad():
        net(torch.from_numpy(mic), torch.from_numpy(far))
    _, sj = jd.dccrn_apply(params, state, jnp.asarray(mic), jnp.asarray(far), cfg_j, train=True)
    _trees_close(net.state(), sj)


def test_registry():
    assert registry.list_models() == ["att_ccrn", "dccrn", "fullsubnet", "little_net",
                                      "two_layer_gru"]
    spec = registry.get_model("dccrn")
    assert spec.stateful and spec.apply is td.dccrn_apply
    assert registry.get_model("att_ccrn").stateful
    assert not registry.get_model("fullsubnet").stateful
    for name in ("dct_dnn", "dct_cnn"):
        with pytest.raises(KeyError, match="ROADMAP A2"):
            registry.get_model(name)
    with pytest.raises(KeyError, match="unknown model"):
        registry.get_model("nope")


def test_make_adapter_dccrn_matches_jax(rng):
    """The DCCRN adapter's loss and enhance on JAX's weights; DccrnConfig()
    at full width, a short utterance."""
    ja, ta = jax_make_adapter("dccrn"), make_adapter("dccrn")
    assert ta.stateful and ja.stateful
    pt, st = ta.init(generator=torch.Generator().manual_seed(7), device="cpu")
    params, state = jax.tree.map(lambda t: jnp.asarray(t.numpy()), (pt, st))
    mic, far, near, echo = _inputs(rng, 1, 2048)
    with torch.no_grad():
        wt = ta.enhance(pt, st, torch.from_numpy(mic), torch.from_numpy(far))
        lt, _ = ta.loss(pt, st, *map(torch.from_numpy, (mic, far, near, echo)), False)
    _close(wt, jax.jit(ja.enhance)(params, state, jnp.asarray(mic), jnp.asarray(far)),
           what="enhance")
    lj, _ = jax.jit(ja.loss, static_argnums=6)(params, state,
                                               *map(jnp.asarray, (mic, far, near, echo)), False)
    _close(lt, lj, 1e-4, "loss")


@pytest.mark.parametrize("name", ["little_net", "two_layer_gru"])
def test_make_adapter_stateless_matches_jax(rng, name):
    from aec_tpu_torch.utils.weights import params_from_jax, two_layer_gru_from_jax

    ja, ta = jax_make_adapter(name), make_adapter(name)
    params, _ = ja.init(jax.random.PRNGKey(8))
    carry = params_from_jax if name == "little_net" else two_layer_gru_from_jax
    net = carry(params, device="cpu")
    net0, state0 = ta.init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert state0 == {} and type(net0) is type(net)
    mic, far, near, echo = _inputs(rng, 2, 4096)
    with torch.no_grad():
        wt = ta.enhance(net, {}, torch.from_numpy(mic), torch.from_numpy(far))
    _close(wt, ja.enhance(params, {}, jnp.asarray(mic), jnp.asarray(far)), what="enhance")
    lt, _ = ta.loss(net, {}, *map(torch.from_numpy, (mic, far, near, echo)), True)
    lj, _ = ja.loss(params, {}, *map(jnp.asarray, (mic, far, near, echo)), True)
    _close(lt, lj, 1e-5, "loss")
    for other in ("dct_dnn", "dct_cnn"):
        with pytest.raises(KeyError, match="ROADMAP A2"):
            make_adapter(other)


def test_dccrn_config_fields_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(jd.DccrnConfig)}
    got = {f.name: f.default for f in dataclasses.fields(td.DccrnConfig)}
    assert set(got) == set(want)
    for k in want:
        if k != "stft":
            assert got[k] == want[k], k
    assert dataclasses.asdict(got["stft"]) == dataclasses.asdict(want["stft"])
    assert td.bottleneck_features(td.DccrnConfig()) == 2048
