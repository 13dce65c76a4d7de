"""The port's example entry points (aec_tpu_torch.examples) == the JAX
package's ``examples/*.py``, on the CPU, at small sizes.

JAX's ``train_step`` and ``eval_metrics`` are closures inside its script's
``main()``, so they are rebuilt here from ``aec_tpu``'s ``kalman_cancel``,
``little_net_loss``, ``little_net_apply`` and optax, as written there; the
other scripts run as they are (``make_corpus``, ``demo_two_stage``) or as
their loop is written (``serving_loop`` at ``--interpret``)."""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from aec_tpu.configs import KalmanConfig as JaxKalmanConfig
from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.dsp.stft import StftConfig as JaxStftConfig
from aec_tpu.kernels import pallas_serving as jsv
from aec_tpu.linear.kalman import kalman_cancel as jax_kalman_cancel
from aec_tpu.models.little_net import little_net_apply as jax_apply
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.little_net import little_net_loss as jax_loss
from aec_tpu.train import checkpoints as jck
from aec_tpu.train.metrics import erle as jax_erle
from aec_tpu.train.metrics import si_snr as jax_si_snr
from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.examples import demo_two_stage as demo
from aec_tpu_torch.examples import make_corpus as corpus
from aec_tpu_torch.examples import serving_loop as serving
from aec_tpu_torch.examples import train_synthetic as ts
from aec_tpu_torch.kernels.serving import serving_erle
from aec_tpu_torch.models.little_net import little_net_loss
from aec_tpu_torch.train import checkpoints as tck
from aec_tpu_torch.train.loop import make_train_step
from aec_tpu_torch.utils.weights import load_npz, params_from_jax, params_to_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints")
N = 16000 // 2 // 256 * 256  # 0.5 s, as the script cuts --seconds 0.5
INFO_KEYS = {"steps", "echo_only_erle_stage1_db", "echo_only_erle_two_stage_db",
             "double_talk_sisnr_linear_db", "double_talk_sisnr_enhanced_db"}


def _jax_example(name):
    """``examples/<name>.py`` of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_draws(key, b, n):
    """The numbers JAX's ``make_scene_fn(n)(key, b)`` draws, keyed as
    :func:`ts.scene_draws` keys them (uniforms at [0, 1), before scaling)."""
    (k_far, k_near, k_rir, k_gain, k_snr, k_act, k_tilt,
     k_kind, k_nl, k_delay, k_nkind) = jax.random.split(key, 11)

    def u(k, shape=(b, 1)):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))

    def z(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    def role(k):
        k_env_shaped, _ = jax.random.split(k)
        k_f0, k_ph, k_env, k_noise = jax.random.split(k, 4)
        return {"white": z(k, (b, n)), "env": u(k_env_shaped), "f0": u(k_f0),
                "harmonics": u(k_ph, (b, 6)), "syllable": u(k_env), "noise": z(k_noise, (b, n))}

    return {"far": role(k_far), "near": role(k_near), "kind": u(k_kind), "near_kind": u(k_nkind),
            "active": u(k_act), "tilt": u(k_tilt), "decay": u(k_rir),
            "rir": z(k_rir, (b, ts.RIR_LEN + ts.MAX_DELAY)),
            "delay": torch.from_numpy(np.array(jax.random.randint(k_delay, (b, 1), 0,
                                                                  ts.MAX_DELAY))),
            "gain": u(k_gain), "nonlinear": u(k_nl), "snr": u(k_snr)}


def _scenes(seed, b, n=N):
    """(far, mic, near) numpy scenes from the port's synthesizer."""
    draws = ts.scene_draws(torch.Generator().manual_seed(seed), b, n)
    return tuple(x.numpy() for x in ts.synthesize_scenes(draws, n))


def test_example_modules_import_and_train_without_jax(tmp_path):
    """With jax, optax, aec_tpu and benchmarks blocked, every example module
    imports and ``train_synthetic.main`` runs a step on the CPU; the
    checkpoint it writes restores in JAX's ``checkpoints.restore`` with the
    same arrays as the port's ``load_npz`` reads, and carries the JAX
    script's ``.json`` keys."""
    out = tmp_path / "ln.npz"
    code = (
        "import sys\n"
        "for m in ('jax', 'optax', 'aec_tpu', 'benchmarks'):\n"
        "    sys.modules[m] = None\n"
        "from aec_tpu_torch.examples import demo_two_stage, make_corpus, serving_loop\n"
        "from aec_tpu_torch.examples import train_synthetic\n"
        f"train_synthetic.main(['--steps', '2', '--batch', '2', '--seconds', '0.25', "
        f"'--out', {str(out)!r}, '--device', 'cpu'])\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(info) == INFO_KEYS and info["steps"] == 2
    assert tck.load_info(str(out)) == info
    restored = jck.restore(str(out), {"params": jax_init(jax.random.PRNGKey(0))})["params"]
    net = load_npz(str(out), device="cpu")
    for a, leaves in params_to_jax(net).items():
        for b, leaf in leaves.items():
            np.testing.assert_array_equal(np.asarray(restored[a][b]), leaf, err_msg=f"{a}.{b}")


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A checkpoint JAX's ``checkpoints.save`` writes (as its script saves
    ``{"params": params}``) loads in the port's ``cli/infer.load_params``."""
    from aec_tpu_torch.cli.infer import load_params

    params = jax_init(jax.random.PRNGKey(3), width=2)
    jck.save(str(tmp_path / "j.npz"), {"params": params}, {"steps": 1})
    net = load_params(str(tmp_path / "j.npz"), device="cpu")
    want = _np_tree(params)
    for a, leaves in params_to_jax(net).items():
        for b, leaf in leaves.items():
            np.testing.assert_array_equal(leaf, want[a][b], err_msg=f"{a}.{b}")


def test_cumsum_blocked_is_xla_cpus_order():
    """``_cumsum_blocked`` sums in the order of ``jnp.cumsum`` on the CPU: bit
    for bit, at lengths with and without a partial last run."""
    rng = np.random.default_rng(0)
    for n in (7, 16, 17, 4000, 7936, 16128, 64000):
        x = rng.uniform(90.0, 250.0, (3, n)).astype(np.float32)
        np.testing.assert_array_equal(ts._cumsum_blocked(torch.from_numpy(x)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)),
                                      err_msg=f"n = {n}")


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_scenes_against_jax(seed):
    """``synthesize_scenes`` fed the numbers JAX draws for a key vs
    ``make_scene_fn(n)(key, b)``, 1 s of 6 scenes. A row with no harmonic
    excitation within 1e-5 of its scale. A row carrying one (a harmonic
    far end, an active harmonic near end, the mic of either) within 2e-3:
    the pitch phase is a float32 running sum of 16,128 increments, where a
    one-ulp difference between two ``sin`` implementations flips later
    roundings of the sum; JAX's own jitted and eager evaluations of these
    scenes differ by up to 8.2e-4 of scale on such rows (12 keys)."""
    b, n = 6, 16128
    key = jax.random.PRNGKey(seed)
    want = [np.asarray(x) for x in _jax_example("train_synthetic").make_scene_fn(n)(key, b)]
    draws = _jax_draws(key, b, n)
    got = [x.numpy() for x in ts.synthesize_scenes(draws, n)]
    harm_far = draws["kind"].numpy()[:, 0] < 0.5
    harm_near = (draws["near_kind"].numpy()[:, 0] < 0.5) & (draws["active"].numpy()[:, 0] < 0.7)
    for name, g, w, harm in zip(("far", "mic", "near"), got, want,
                                (harm_far, harm_far | harm_near, harm_near)):
        assert g.shape == w.shape == (b, n) and g.dtype == np.float32
        scale = np.abs(w).max(-1) + 1e-12
        rel = np.abs(g - w).max(-1) / scale
        bar = np.where(harm, 2e-3, 1e-5)
        assert (rel <= bar).all(), (name, rel, harm)
    assert harm_far.any() and (~harm_far).any()  # both bars held


def test_scene_draws_reproduce_jaxs_ties():
    """One ``u`` scaled twice where JAX draws two uniforms of one shape from
    one key: the envelope's rate and phase (``phase == 2 pi (rate - 2) / 4``),
    the pitch and its drift's phase, the syllabic rate and phase; JAX's own
    draws obey the same relations. The draws lie where JAX's do."""
    b, n = 64, 512
    draws = ts.scene_draws(torch.Generator().manual_seed(1), b, n)
    key = jax.random.PRNGKey(2)
    k_env = jax.random.split(key)[0]
    k_f0, _, k_syl, _ = jax.random.split(key, 4)
    ties = (  # (port draw, JAX key, (lo, hi) of the first use, (lo, hi) of the second)
        ("env", k_env, (2.0, 6.0), (0.0, 2 * np.pi)),
        ("f0", k_f0, (90.0, 230.0), (0.0, 6.28)),
        ("syllable", k_syl, (2.5, 4.5), (0.0, 6.28)),
    )
    for role in ("far", "near"):
        for name, k, (lo1, hi1), (lo2, hi2) in ties:
            first = ts._uniform(draws[role][name], lo1, hi1).double().numpy()
            second = ts._uniform(draws[role][name], lo2, hi2).double().numpy()
            np.testing.assert_allclose(second, (first - lo1) / (hi1 - lo1) * hi2, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{role} {name}")
            j1 = np.asarray(jax.random.uniform(k, (b, 1), minval=lo1, maxval=hi1), np.float64)
            j2 = np.asarray(jax.random.uniform(k, (b, 1), minval=lo2, maxval=hi2), np.float64)
            np.testing.assert_allclose(j2, (j1 - lo1) / (hi1 - lo1) * hi2, rtol=1e-5, atol=1e-5)
        assert draws[role]["white"].shape == draws[role]["noise"].shape == (b, n)
        assert draws[role]["harmonics"].shape == (b, 6)
    assert draws["rir"].shape == (b, ts.RIR_LEN + ts.MAX_DELAY)
    delay = draws["delay"].numpy()
    assert delay.dtype == np.int64 and delay.min() >= 0 and delay.max() < ts.MAX_DELAY
    for k in ("kind", "near_kind", "active", "tilt", "decay", "gain", "nonlinear", "snr"):
        u = draws[k].numpy()
        assert u.shape == (b, 1) and u.min() >= 0.0 and u.max() < 1.0, k


def test_cosine_schedule_against_optax():
    """The optimizer's schedule vs ``optax.cosine_decay_schedule(lr, steps,
    0.05)`` at the first count, mid-way, the last and beyond ``steps``."""
    lr, steps = 3e-3, 1500
    mine = ts.recipe_optimizer(torch.nn.Linear(2, 2), lr, steps).schedule
    theirs = optax.cosine_decay_schedule(lr, steps, 0.05)
    for count in (0, 1, 750, 1499, 1500, 4000):
        np.testing.assert_allclose(mine(count), float(theirs(count)), rtol=1e-6,
                                   err_msg=f"count {count}")


def _jax_step(params, lin, far, near, erb, lr, steps, balance, asym, sisnr):
    """JAX's ``train_step`` after its scenes and stage 1, as
    ``examples/train_synthetic.py`` writes it -> (new params, loss, the
    per-scene losses of ``--balance`` or None)."""
    scfg = JaxStftConfig()
    opt = optax.chain(optax.clip_by_global_norm(5.0),
                      optax.adam(optax.cosine_decay_schedule(lr, steps, 0.05)))
    opt_state = opt.init(params)

    def per_scene_losses(p):
        def per_scene(l1, f1, n1):
            li, _ = jax_loss(p, l1[None], f1[None], n1[None], erb, scfg, normalize=False,
                             sqrt_eps=1e-12, asym_weight=asym)
            return li

        return jax.vmap(per_scene)(lin, far, near)

    def lf(p):
        if balance:
            li = per_scene_losses(p)
            return jnp.mean(li / (jax.lax.stop_gradient(li) + 1e-2))
        loss, _ = jax_loss(p, lin, far, near, erb, scfg, sqrt_eps=1e-12, asym_weight=asym,
                           sisnr_weight=sisnr, gain_norm=sisnr > 0)
        return loss

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(lf)(p)
        updates, _ = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), loss, per_scene_losses(p) if balance else None

    return step(params)


@pytest.mark.parametrize("recipe", [
    {}, {"balance": True}, {"asym": 3.0, "sisnr": 0.2}, {"width": 2}],
    ids=["default", "balance", "asym_sisnr", "width2"])
def test_train_step_against_jax(recipe):
    """One step of each recipe from the same scenes and carried-over
    weights: stage 1 on each package's own canceller, then the loss and
    the update: loss rtol 1e-4, each leaf's mean |d| <= 1e-3 lr; with
    ``--balance`` the per-scene losses of one batched forward vs JAX's
    vmap of the batch-1 loss at rtol 1e-5."""
    lr, steps = 3e-3, 100
    balance, asym, sisnr = recipe.get("balance", False), recipe.get("asym", 0.0), recipe.get(
        "sisnr", 0.0)
    far, mic, near = _scenes(5, 3)
    params = jax_init(jax.random.PRNGKey(1), width=recipe.get("width", 1))
    erb = erb_filterbank()
    lin_j = jax_kalman_cancel(JaxKalmanConfig(), jnp.asarray(far), jnp.asarray(mic),
                              block=256)["wav"]
    new_j, loss_j, per_j = _jax_step(params, lin_j, jnp.asarray(far), jnp.asarray(near),
                                     jnp.asarray(erb), lr, steps, balance, asym, sisnr)

    net = params_from_jax(_np_tree(params), device="cpu")
    far_t, mic_t, near_t = map(torch.from_numpy, (far, mic, near))
    erb_t = torch.from_numpy(erb)
    lin_t = ts.linear_output(KalmanConfig(), far_t, mic_t)
    np.testing.assert_allclose(lin_t.numpy(), np.asarray(lin_j), rtol=0,
                               atol=1e-5 * float(np.abs(mic).max()))
    if balance:
        per_t, _ = little_net_loss(net, lin_t, far_t, near_t, erb_t, normalize=False,
                                   sqrt_eps=1e-12, asym_weight=asym, per_scene=True)
        assert per_t.shape == (3,)
        np.testing.assert_allclose(per_t.detach().numpy(), np.asarray(per_j), rtol=1e-5)
    step = make_train_step(ts.recipe_loss(balance, asym, sisnr),
                           ts.recipe_optimizer(net, lr, steps))
    loss_t = step(lin_t, far_t, near_t, erb_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    got, want = params_to_jax(net), _np_tree(new_j)
    for a in want:
        for b in want[a]:
            d = np.abs(got[a][b] - want[a][b])
            assert d.mean() <= 1e-3 * lr, (a, b, d.mean())
            assert np.abs(got[a][b] - np.asarray(params[a][b])).max() > 0.5 * lr  # it moved


def test_per_scene_loss_refuses_terms_that_span_the_batch():
    """``per_scene`` with the pseudo-norm or the SI-SNR term raises: both
    take statistics over the batch."""
    far, mic, near = map(torch.from_numpy, _scenes(0, 2, 2048))
    net = params_from_jax(_np_tree(jax_init(jax.random.PRNGKey(0))), device="cpu")
    erb = torch.from_numpy(erb_filterbank())
    for kw in ({"normalize": True}, {"normalize": False, "sisnr_weight": 0.1}):
        with pytest.raises(ValueError, match="per_scene"):
            little_net_loss(net, mic, far, near, erb, per_scene=True, **kw)


def test_eval_metrics_against_jax():
    """``eval_metrics`` on the same 4 scenes and carried-over weights vs
    JAX's (stage 1 on the scenes and their echo-only variant, the net's
    offline apply, ERLE and the active scenes' SI-SNR): within 0.1 dB."""
    far, mic, near = _scenes(9, 4)
    params = jax_init(jax.random.PRNGKey(2))
    erb = erb_filterbank()
    kcfg, scfg = JaxKalmanConfig(), JaxStftConfig()
    half = N // 2

    def sisnr_active(est, nr):
        per = jax.vmap(lambda e, t: jax_si_snr(e[None, half:], t[None, half:]))(est, nr)
        act = (jnp.mean(nr * nr, axis=-1) > 1e-8).astype(jnp.float32)
        return jnp.sum(per * act) / jnp.maximum(jnp.sum(act), 1.0)

    @jax.jit
    def eval_metrics(f, m, nr):
        lin = jax_kalman_cancel(kcfg, f, m, block=scfg.hop)["wav"]
        enh = jax_apply(params, lin, f, jnp.asarray(erb), scfg)["wav"]
        mic_e = m - nr
        lin_e = jax_kalman_cancel(kcfg, f, mic_e, block=scfg.hop)["wav"]
        enh_e = jax_apply(params, lin_e, f, jnp.asarray(erb), scfg)["wav"]
        return (jax_erle(mic_e[:, half:], lin_e[:, half:]),
                jax_erle(mic_e[:, half:], enh_e[:, half:]),
                sisnr_active(lin, nr), sisnr_active(enh, nr))

    want = eval_metrics(*map(jnp.asarray, (far, mic, near)))

    net = params_from_jax(_np_tree(params), device="cpu")
    got = ts.eval_metrics(net, *map(torch.from_numpy, (far, mic, near)), torch.from_numpy(erb))
    for name, g, w in zip(("erle_stage1", "erle_two_stage", "sisnr_lin", "sisnr_enh"), got, want):
        assert np.isfinite(float(g)) and abs(float(g) - float(w)) <= 0.1, (name, float(g),
                                                                           float(w))


def test_demo_two_stage_against_jax(tmp_path, monkeypatch):
    """``demo_two_stage --seconds 2 --model_file
    checkpoints/little_net_synthetic.npz``: the port's report within 0.1 dB
    of JAX's script's (``xrt`` is each run's own), the scene's wavs equal
    bit for bit, the outputs' wavs within 1e-4 of their scale."""
    model = os.path.join(CKPT, "little_net_synthetic.npz")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["demo", "--seconds", "2", "--model_file", model,
                                      "--out_dir", str(jdir)])
    _jax_example("demo_two_stage").main()
    demo.main(["--seconds", "2", "--model_file", model, "--out_dir", str(tdir),
               "--device", "cpu"])
    want = json.loads((jdir / "report.json").read_text())
    got = json.loads((tdir / "report.json").read_text())
    assert set(got) == set(want)
    for k in want:
        if k != "xrt":
            assert abs(got[k] - want[k]) <= 0.1, (k, got[k], want[k])
    assert got["xrt"] > 0
    for name in ("far", "mic", "near"):
        assert filecmp.cmp(jdir / f"{name}.wav", tdir / f"{name}.wav", shallow=False), name
    from aec_tpu_torch.pipeline.audio_io import read_wav

    for name in ("linear", "enhanced"):
        w, g = read_wav(str(jdir / f"{name}.wav"))[0], read_wav(str(tdir / f"{name}.wav"))[0]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()), err_msg=name)


def test_serving_loop_against_jax():
    """``serving_loop`` at S = 4, 8 blocks on the CPU vs the JAX script's
    loop at ``--interpret`` (``dot_mode="high"``) on the same sessions and
    the general checkpoint: each emitted block within 2e-4 of its scale and
    the live ERLE monitor at rtol 3e-4 (``tests/test_torch_serving.py``'s
    bars)."""
    s, blocks, hop = 4, 8, serving.HOP
    far, mic = serving.make_sessions(s, blocks)
    out_t, lat, state = serving.serve(serving.load_net("cpu"), far, mic, "cpu")
    assert len(lat) == blocks and out_t.shape == mic.shape

    params = jck.restore(serving.CHECKPOINT, {"params": jax_init(jax.random.PRNGKey(0))})["params"]
    erb = jnp.asarray(erb_filterbank())
    js = jsv.serving_init(s, tile=s)
    out_j = np.zeros_like(mic)
    for t in range(blocks):
        blk = slice(t * hop, (t + 1) * hop)
        js, o = jsv.serving_step_fused(params, js, jnp.asarray(far[:, blk]),
                                       jnp.asarray(mic[:, blk]), erb, interpret=True,
                                       dot_mode="high")
        if t:
            out_j[:, (t - 1) * hop : t * hop] = np.asarray(o)
    for t in range(blocks - 1):
        blk = slice(t * hop, (t + 1) * hop)
        scale = max(float(np.abs(out_j[:, blk]).max()), 1e-9)
        np.testing.assert_allclose(out_t[:, blk], out_j[:, blk], rtol=0, atol=2e-4 * scale,
                                   err_msg=f"block {t}")
    np.testing.assert_allclose(serving_erle(state).numpy(), np.asarray(jsv.serving_erle(js)),
                               rtol=3e-4)


def test_make_corpus_is_byte_equal_to_jaxs(tmp_path, monkeypatch):
    """``make_corpus --count 2 --val 1 --seconds 0.5``: every file the port
    writes equals the JAX script's byte for byte."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    argv = ["--count", "2", "--val", "1", "--seconds", "0.5"]
    monkeypatch.setattr(sys, "argv", ["make_corpus", "--out", str(jdir), *argv])
    _jax_example("make_corpus").main()
    corpus.main(["--out", str(tdir), *argv])
    for split, count in (("train", 2), ("val", 1)):
        names = sorted(os.listdir(jdir / split))
        assert names == sorted(os.listdir(tdir / split)) and len(names) == 4 * count
        match, mismatch, errors = filecmp.cmpfiles(jdir / split, tdir / split, names,
                                                   shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
