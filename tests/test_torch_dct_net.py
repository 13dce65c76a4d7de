"""Port DCT nets (aec_tpu_torch.models.dct_net, their weight carry and
registry entries) == JAX, on the same numpy inputs and JAX's weights carried
over; and both train on the port's make_stateful_train_step as
tests/test_convergence.py trains JAX's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.models import dct_net as jd
from aec_tpu.models.registry import get_model as jax_get_model
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.models import dct_net as td
from aec_tpu_torch.models import registry
from aec_tpu_torch.models.tree_net import model_state
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.utils import weights

# fp32 round-off of framing, DCT products, convolutions and the GRU in
# another summation order, of each output's scale
REL = 1e-5

NETS = {
    "dct_dnn": (jd.dnn_init, jd.dnn_apply, jd.dnn_loss, td.dnn_apply, td.dnn_loss,
                weights.dct_dnn_from_jax, weights.dct_dnn_to_jax, td.DctDnn),
    "dct_cnn": (jd.cnn_init, jd.cnn_apply, jd.cnn_loss, td.cnn_apply, td.cnn_loss,
                weights.dct_cnn_from_jax, weights.dct_cnn_to_jax, td.DctCnn),
}


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} x {scale:.3e}"


def _signals(rng, b=2, n=4096):
    noisy = (0.5 * rng.standard_normal((b, n))).astype(np.float32)
    clean = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
    return noisy, clean


@pytest.mark.parametrize("n", [8, 64, 512])
def test_dct_matrix_matches_jax(n):
    """The port's own copy of the DCT-II basis equals JAX's, and is
    orthonormal (its transpose is its inverse, which dnn/cnn_apply use)."""
    m = td.dct_matrix(n).numpy()
    np.testing.assert_array_equal(m, np.asarray(jd.dct_matrix(n)))
    np.testing.assert_allclose(m @ m.T, np.eye(n), atol=1e-5)


def test_dct_features_and_overlap_add_match_jax(rng):
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    for win, hop in ((512, 256), (256, 64)):
        got = td.dct_features(torch.from_numpy(x), win, hop)
        _close(got, jd.dct_features(jnp.asarray(x), win, hop), what=f"features {win}/{hop}")
        _close(td.raw_overlap_add(got, hop), jd.raw_overlap_add(jnp.asarray(got.numpy()), hop),
               what=f"ola {win}/{hop}")


@pytest.mark.parametrize("name", sorted(NETS))
def test_apply_loss_and_module_match_jax(rng, name):
    """Forward (every output), loss and the module's forward on JAX's
    weights; the carry round-trips leaf for leaf."""
    jinit, japply, jloss, tapply, tloss, carry, back, cls = NETS[name]
    params = jinit(jax.random.PRNGKey(0))
    net = carry(params, device="cpu")
    assert isinstance(net, cls)
    jax.tree.map(np.testing.assert_array_equal, back(net), jax.tree.map(np.asarray, params))
    noisy, clean = _signals(rng)
    want = japply(params, jnp.asarray(noisy))
    with torch.no_grad():
        got = tapply(net.params(), torch.from_numpy(noisy))
        module_out = net(torch.from_numpy(noisy))
        lt, _ = tloss(net.params(), torch.from_numpy(noisy), torch.from_numpy(clean))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)
        assert torch.equal(module_out[k], got[k]), k
    lj, _ = jloss(params, jnp.asarray(noisy), jnp.asarray(clean))
    _close(lt, lj, what="loss")


@pytest.mark.parametrize("name", sorted(NETS))
def test_init_policy_matches_jax(name):
    """The port's init draws the same shapes as JAX's, one seed one net,
    with JAX's biases, slopes and scales (its numbers come from another
    generator)."""
    jinit, tinit = NETS[name][0], {"dct_dnn": td.dnn_init, "dct_cnn": td.cnn_init}[name]
    want = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))
    nets = [tinit(generator=torch.Generator().manual_seed(3), device="cpu") for _ in range(2)]
    got = jax.tree.map(lambda t: t.numpy(), nets[0])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_equal(g.shape, w.shape), got, want)
    jax.tree.map(np.testing.assert_array_equal, got,
                 jax.tree.map(lambda t: t.numpy(), nets[1]))
    if name == "dct_dnn":
        for lin, fan_in in (("lin1", 100), ("lin2", 100), ("lin3", 100)):
            assert np.abs(got[lin]["w"]).max() <= 1 / np.sqrt(fan_in)
        assert float(got["prelu1"]) == float(got["prelu2"]) == 0.25
    else:
        for layer in got["encoder"] + got["decoder"]:
            assert not layer["conv"]["b"].any() and float(layer["prelu"]) == 0.25
        assert abs(float(np.std(got["encoder"][2]["conv"]["w"])) - 0.05) < 0.01


def test_config_fields_match_jax():
    for j, t in ((jd.DctDnnConfig, td.DctDnnConfig), (jd.DctCnnConfig, td.DctCnnConfig)):
        assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_registry_has_every_jax_family():
    """The port's registry lists JAX's families, the DCT nets with JAX's
    reference strings; nothing is left in NOT_PORTED."""
    assert registry.NOT_PORTED == {}
    for name in ("dct_dnn", "dct_cnn"):
        spec, jspec = registry.get_model(name), jax_get_model(name)
        assert not spec.stateful and spec.reference == jspec.reference
        assert spec.loss is getattr(td, jspec.loss.__name__)


def _scene(rng, b=2, n=4096):
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
    echo = np.stack([np.convolve(f, 0.3 * rir)[:n] for f in far]).astype(np.float32)
    near = (0.2 * rng.standard_normal((b, n))).astype(np.float32)
    return tuple(map(torch.from_numpy, (near + echo, far, near, echo)))


@pytest.mark.parametrize("name", sorted(NETS))
def test_dct_families_converge_on_the_port_step(rng, name):
    """tests/test_convergence.py's check on the port's train step: 20
    make_stateful_train_step steps of Adam at lr 1e-3 on one batch of the
    denoising contract (noisy mic -> clean near end) lower the loss."""
    spec = registry.get_model(name)
    net = {"dct_dnn": td.DctDnn, "dct_cnn": td.DctCnn}[name](
        spec.init(generator=torch.Generator().manual_seed(3), device="cpu"))
    opt = tloop.make_optimizer(TrainConfig(lr=1e-3), 1000, net)

    def loss_fn(p, s, mic, far, near, echo):
        return spec.loss(p, mic, near)[0], {"state": s}

    step = tloop.make_stateful_train_step(loss_fn, opt)
    batch = _scene(rng)
    losses = [float(step(model_state(net), *batch)[1]) for _ in range(20)]
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) and losses[-1] < losses[0], losses
