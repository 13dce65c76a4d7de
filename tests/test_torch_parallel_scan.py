"""The port's tensor-parallel LSTM (parallel/tp_lstm), ATT-CCRN's
``lstm_mesh`` route and the pipelined scan (parallel/seq_scan) on 2 and 4
gloo ranks == the dense scans and JAX's, with JAX's bars
(tests/test_parallel.py, tests/test_seq_scan.py).

The ranks start once per world size for the file (module fixture), one
intra-op thread each, the worker in tests/torch_parallel_ranks.py.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import KalmanConfig as JaxKalmanConfig
from aec_tpu.linear.kalman import kalman_init as jax_kalman_init
from aec_tpu.linear.kalman import kalman_step as jax_kalman_step
from aec_tpu.models import att_ccrn as jatt
from aec_tpu.ops.gru import gru_init as jax_gru_init
from aec_tpu.ops.lstm import lstm_init as jax_lstm_init
from aec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from aec_tpu.parallel.tp_lstm import lstm_scan_tp as jax_lstm_scan_tp
from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.linear.kalman import kalman_init, kalman_step
from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply
from aec_tpu_torch.ops.gru import gru_cell
from aec_tpu_torch.ops.lstm import lstm_scan
from aec_tpu_torch.parallel import mesh as tmesh
from aec_tpu_torch.parallel.dryrun import run_ranks
from aec_tpu_torch.parallel.seq_scan import scan
from aec_tpu_torch.parallel.tp_lstm import _gate_perm, lstm_scan_tp
from aec_tpu_torch.utils import weights

import torch_parallel_ranks as ranks

WORLDS = (2, 4)
ATT_CHANNELS = (1, 2, 4, 4, 8)
SPAWN_S = 240


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    aparams, astate = jatt.att_ccrn_init(jax.random.PRNGKey(0),
                                         jatt.AttCcrnConfig(channels=ATT_CHANNELS))
    return {
        "lstm": _np_tree(jax_lstm_init(jax.random.PRNGKey(0), 12, 32)), "x": f32(3, 17, 12),
        "lstm_g": _np_tree(jax_lstm_init(jax.random.PRNGKey(2), 8, 16)), "x_g": f32(2, 11, 8),
        "tgt_g": f32(2, 11, 16),
        "lstm_m": _np_tree(jax_lstm_init(jax.random.PRNGKey(1), 8, 16)), "x_m": f32(2, 9, 8),
        "h0": f32(2, 16), "c0": f32(2, 16),
        "att": (_np_tree(aparams), _np_tree(astate)), "att_channels": ATT_CHANNELS,
        "att_mic": f32(1, 4000), "att_far": f32(1, 4000),
        "gru": _np_tree(jax_gru_init(jax.random.PRNGKey(0), 8, 4)), "gru_xs": f32(5, 48, 8),
        "k_x": f32(3, 16, 2 * 257), "k_d": f32(3, 16, 256),
    }


@pytest.fixture(scope="module")
def runs(case):
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {w: pool.submit(run_ranks, ranks.scans_worker, w, (case,), timeout=SPAWN_S)
               for w in WORLDS}


@pytest.fixture(scope="module")
def dense(case):
    """The references: the port's dense scans and unsharded forward, JAX's
    TP scan on its virtual mesh, the sequential scans."""
    out = {}
    with torch.no_grad():
        out["ys"], (out["h"], out["c"]) = lstm_scan(_t(case["lstm"]), torch.from_numpy(case["x"]))
        out["ys_m"], _ = lstm_scan(_t(case["lstm_m"]), torch.from_numpy(case["x_m"]),
                                   torch.from_numpy(case["h0"]), torch.from_numpy(case["c0"]))
    gp = {k: v.requires_grad_() for k, v in _t(case["lstm_g"]).items()}
    xg = torch.from_numpy(case["x_g"]).requires_grad_()
    torch.mean((lstm_scan(gp, xg)[0] - torch.from_numpy(case["tgt_g"])) ** 2).backward()
    out["grads"] = {k: v.grad.numpy() for k, v in gp.items()}
    out["x_grad"] = xg.grad.numpy()
    for world in WORLDS:
        jmesh = jax_make_mesh(n_data=1, n_model=world, devices=jax.devices()[:world])
        out[("jax_ys", world)] = np.asarray(jax.jit(
            lambda p, x: jax_lstm_scan_tp(p, x, jmesh, "model")[0])(case["lstm"], case["x"]))
        out[("jax_grads", world)] = _np_tree(jax.jit(jax.grad(lambda p: jnp.mean(
            (jax_lstm_scan_tp(p, case["x_g"], jmesh, "model")[0] - case["tgt_g"]) ** 2)))(
            case["lstm_g"]))
    acfg = AttCcrnConfig(channels=ATT_CHANNELS)
    with torch.no_grad():
        net = weights.att_ccrn_from_jax(*case["att"], acfg, device="cpu")
        out["att_wav"] = att_ccrn_apply(net.params(), net.state(),
                                        torch.from_numpy(case["att_mic"]),
                                        torch.from_numpy(case["att_far"]), acfg)[0]["wav"].numpy()
    out["jax_att_wav"] = np.asarray(jatt.att_ccrn_apply(
        *case["att"], case["att_mic"], case["att_far"],
        jatt.AttCcrnConfig(channels=ATT_CHANNELS))[0]["wav"])
    gru = _t(case["gru"])

    def gru_step(h, x_t):
        h_next = gru_cell(gru, h[None], x_t[None] @ gru["w_ih"].T + gru["b_ih"])[0]
        return h_next, h_next

    with torch.no_grad():
        seq = [scan(gru_step, torch.zeros(4), torch.from_numpy(xs)) for xs in case["gru_xs"]]
        out["gru_finals"] = np.stack([h.numpy() for h, _ in seq])
        out["gru_ys"] = np.stack([ys.numpy() for _, ys in seq])
        kcfg = KalmanConfig(n_blocks=4)
        out["k_ys"] = np.stack([scan(
            lambda s, xd: kalman_step(kcfg, s, xd[0], xd[1], block=256),
            kalman_init(kcfg, 257), (torch.from_numpy(x), torch.from_numpy(d)))[1].numpy()
            for x, d in zip(case["k_x"], case["k_d"])])
    jcfg = JaxKalmanConfig(n_blocks=4)
    out["jax_k_ys"] = np.stack([np.asarray(jax.lax.scan(
        lambda s, xd: jax_kalman_step(jcfg, s, xd[0], xd[1], block=256),
        jax_kalman_init(jcfg, 257), (x, d))[1]) for x, d in zip(case["k_x"], case["k_d"])])
    return out


@pytest.fixture(scope="module")
def ranks_out(runs, dense):
    return {w: run.result() for w, run in runs.items()}


def _slice(a, d, world):
    hp = a.shape[-1] // world
    return a[..., d * hp:(d + 1) * hp]


def test_gate_perm_is_jax():
    from aec_tpu.parallel.tp_lstm import _gate_perm as jax_gate_perm

    for hidden, d in ((32, 2), (32, 4), (4096, 8), (12, 3)):
        np.testing.assert_array_equal(_gate_perm(hidden, d), jax_gate_perm(hidden, d))


def test_one_rank_tp_scan_is_the_dense_scan():
    """On a 1 x 1 mesh (no process group) the TP scan is the dense scan;
    H must divide by the axis; the int8 stream is refused."""
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(v) for k, v in _np_tree(jax_lstm_init(
        jax.random.PRNGKey(3), 6, 8)).items()}
    x = torch.from_numpy(rng.standard_normal((2, 5, 6)).astype(np.float32))
    m = tmesh.make_mesh()
    ys, (h, c) = lstm_scan_tp(p, x, m)
    want, (hw, cw) = lstm_scan(p, x)
    for a, b in ((ys, want), (h, hw), (c, cw)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-6)
    with pytest.raises(ValueError, match="int8"):
        lstm_scan_tp(p, x, m, recurrent_dtype="int8")


@pytest.mark.parametrize("world", WORLDS)
def test_tp_lstm_matches_dense_scan_and_jax(ranks_out, dense, world):
    """lstm_scan_tp on a 1 x world mesh: each rank's ys slice, and h_T and
    c_T, within 2e-6 of the dense lstm_scan; the slices within 2e-6 of
    JAX's lstm_scan_tp on the same mesh shape; the pre-sharded params give
    the same result (1e-6)."""
    for o in ranks_out[world]:
        tp, d = o["tp"], o["tp"]["index"]
        np.testing.assert_allclose(tp["ys"], _slice(dense["ys"].numpy(), d, world), atol=2e-6)
        np.testing.assert_allclose(tp["h"], dense["h"].numpy(), atol=2e-6)
        np.testing.assert_allclose(tp["c"], dense["c"].numpy(), atol=2e-6)
        np.testing.assert_allclose(tp["ys"], _slice(dense[("jax_ys", world)], d, world),
                                   atol=2e-6)
        np.testing.assert_allclose(tp["ys_sharded"], tp["ys"], atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_lstm_gradients_match_dense(ranks_out, dense, world):
    """The ranks' shares of the mean square error, backward through the TP
    scan: the weights' gradients summed over the axis within 1e-6 of the
    dense scan's and of JAX's jax.grad through its TP scan; the input's
    gradient whole on every rank (1e-6)."""
    for o in ranks_out[world]:
        for k, want in dense["grads"].items():
            np.testing.assert_allclose(o["tp_grads"][k], want, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(o["tp_grads"][k], dense[("jax_grads", world)][k],
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(o["tp_x_grad"], dense["x_grad"], atol=1e-6)


def test_tp_lstm_initial_state_on_mixed_mesh(ranks_out, dense):
    """h0 / c0 through the TP scan on a 2 x 2 data x model mesh, each data
    row its rows of the batch: within 2e-6 of the dense scan."""
    for o in ranks_out[4]:
        m = o["mixed"]
        rows = slice(*m["rows"])
        np.testing.assert_allclose(m["ys"], _slice(dense["ys_m"].numpy()[rows], m["index"], 2),
                                   atol=2e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_att_ccrn_lstm_mesh_matches_unsharded(ranks_out, dense, world):
    """att_ccrn_apply(lstm_mesh=...) on every rank == the unsharded forward
    (the port's and JAX's) within 1e-5."""
    for o in ranks_out[world]:
        np.testing.assert_allclose(o["att_wav"], dense["att_wav"], atol=1e-5)
        np.testing.assert_allclose(o["att_wav"], dense["jax_att_wav"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_gru_matches_sequential(ranks_out, dense, world):
    """5 sequences x 48 frames of a GRU step through the pipeline: each
    rank's frames and the finals within 1e-5 of the sequential scan."""
    chunk = 48 // world
    for o in ranks_out[world]:
        d = o["gru"]["index"]
        np.testing.assert_allclose(o["gru"]["ys"], dense["gru_ys"][:, d * chunk:(d + 1) * chunk],
                                   atol=1e-5)
        np.testing.assert_allclose(o["gru"]["finals"], dense["gru_finals"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_kalman_matches_sequential(ranks_out, dense, world):
    """kalman_step (KalmanConfig(n_blocks=4)), 3 sequences x 16 blocks
    through the pipeline: within 1e-4 of the sequential scan, which is
    within 1e-4 of JAX's lax.scan."""
    np.testing.assert_allclose(dense["k_ys"], dense["jax_k_ys"], atol=1e-4)
    chunk = 16 // world
    for r, o in enumerate(ranks_out[world]):
        np.testing.assert_allclose(o["kalman"]["ys"],
                                   dense["k_ys"][:, r * chunk:(r + 1) * chunk], atol=1e-4)
        assert all(v.shape[0] == 3 for v in o["kalman"]["finals"].values())
