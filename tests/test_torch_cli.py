"""Port CLIs == JAX's, on the CPU: ``cli/batch_enhance``, ``cli/stream``,
``cli/measure``, ``cli/export_pt`` and ``utils/torch_compat`` (``.pt`` files
both ways), ``cli/infer`` on a ``.pt``, ``cli/profile`` with
``utils/profiling``; and every new CLI without JAX."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aec_tpu.cli import batch_enhance as jbatch
from aec_tpu.cli import export_pt as jexport
from aec_tpu.cli import measure as jmeasure
from aec_tpu.cli import stream as jstream
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.registry import get_model as jax_model
from aec_tpu.pipeline import audio_io as jio
from aec_tpu.train import checkpoints as jck
from aec_tpu.utils import torch_compat as jtc
from aec_tpu.utils.tools import num_params as jax_num_params
from aec_tpu_torch.cli import batch_enhance, export_pt, infer, measure, profile, stream
from aec_tpu_torch.models import dccrn as td
from aec_tpu_torch.models.registry import list_models
from aec_tpu_torch.pipeline import h5io
from aec_tpu_torch.pipeline.audio_io import read_wav, write_wav
from aec_tpu_torch.utils import profiling, torch_compat
from aec_tpu_torch.utils.weights import load_npz, params_to_jax

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "checkpoints", "little_net_general.npz")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these many small CPU ops: the suite runs
    several workers on one machine, where spinning thread pools multiply
    their time; the previous count is restored after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(rng, n):
    far = (0.5 * rng.standard_normal(n)).astype(np.float32)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    echo = np.convolve(far, 0.4 * rir)[:n].astype(np.float32)
    near = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return {"nearend_speech": near, "nearend_mic": near + echo, "farend_speech": far,
            "echo": echo}


@pytest.fixture(scope="module")
def tt_list(tmp_path_factory):
    """Three test utterances (one shorter, one hop-fractional) in a grouped
    ``.ex`` file and the list naming it."""
    d = tmp_path_factory.mktemp("tt")
    rng = np.random.default_rng(21)
    path = str(d / "test.ex")
    h5io.write_grouped(path, [_scene(rng, n) for n in (8192, 6000, 8192)])
    lst = str(d / "tt_list.txt")
    h5io.write_filelist(lst, [path])
    return lst


def _close(got, want, rel, what):
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= rel * max(float(np.abs(want).max()), 1e-9), what


@pytest.mark.parametrize("stage1", ["kalman", "nlms"])
def test_batch_enhance_matches_jax(tmp_path, tt_list, stage1, capsys):
    """Batches of 2 (the second a batch of one) through stage 1 and LittleNet
    with the per-utterance pseudo-norm: each ``<k>_enhanced.wav`` within
    1e-4 of scale of JAX's; the report's counts equal. ``--mesh`` on one
    process gives the same files (several ranks:
    tests/test_torch_parallel_cli.py)."""
    reports = {}
    for name, main, extra in (("jax", jbatch.main, []),
                              ("port", batch_enhance.main, ["--device", "cpu"])):
        main(["--tt_list", tt_list, "--model_file", CKPT, "--out_dir", str(tmp_path / name),
              "--batch", "2", "--bucket", "4096", "--stage1", stage1, *extra])
        reports[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in range(3):
        want = jio.read_wav(str(tmp_path / "jax" / f"{k}_enhanced.wav"))[0]
        got = read_wav(str(tmp_path / "port" / f"{k}_enhanced.wav"))[0]
        _close(got, want, 1e-4, k)
    for key in ("utterances", "audio_seconds"):
        assert reports["port"][key] == reports["jax"][key]
    assert set(reports["port"]) == set(reports["jax"]) and reports["port"]["xrt"] > 0
    # --mesh in one process (no coordinator: a 1 x 1 mesh) writes the same files
    batch_enhance.main(["--tt_list", tt_list, "--model_file", CKPT, "--out_dir",
                        str(tmp_path / "m"), "--batch", "2", "--bucket", "4096", "--stage1",
                        stage1, "--mesh", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["utterances"] == 3
    for k in range(3):
        np.testing.assert_array_equal(read_wav(str(tmp_path / "m" / f"{k}_enhanced.wav"))[0],
                                      read_wav(str(tmp_path / "port" / f"{k}_enhanced.wav"))[0])


def test_stream_matches_jax(tmp_path, capsys):
    """12 hops and a tail through the Kalman streaming step with the causal
    pseudo-norm: the wav within 1e-4 of scale of JAX's CLI; the report's
    keys and block count equal."""
    sc = _scene(np.random.default_rng(8), 12 * 256 + 100)
    far, mic = str(tmp_path / "far.wav"), str(tmp_path / "mic.wav")
    write_wav(far, sc["farend_speech"], 16000)
    write_wav(mic, sc["nearend_mic"], 16000)
    reports = {}
    for name, main, extra in (("jax", jstream.main, []),
                              ("port", stream.main, ["--device", "cpu"])):
        main(["--far", far, "--mic", mic, "--out", str(tmp_path / f"{name}.wav"),
              "--model_file", CKPT, "--normalize", *extra])
        reports[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jio.read_wav(str(tmp_path / "jax.wav"))[0]
    _close(read_wav(str(tmp_path / "port.wav"))[0], want, 1e-4, "stream")
    assert want.shape == (12 * 256,)
    assert set(reports["port"]) == set(reports["jax"])
    assert reports["port"]["blocks"] == reports["jax"]["blocks"] == 12


def test_measure_json_matches_jax(tmp_path, capsys):
    """``--est_dir`` over two utterances with every metric and the opt-in
    from-spec PESQ, and one ``--est``/``--ref`` pair: the JSON within 1e-5
    of JAX's (relative above 1); without the opt-in PESQ exits."""
    rng = np.random.default_rng(12)
    d = tmp_path / "est"
    d.mkdir()
    for k in range(2):
        near = (0.3 * rng.standard_normal(16000)).astype(np.float32)
        write_wav(str(d / f"{k}_near.wav"), near, 16000)
        write_wav(str(d / f"{k}_near_est.wav"), near + 0.05 * rng.standard_normal(16000), 16000)
        write_wav(str(d / f"{k}_mic.wav"), near + rng.standard_normal(16000), 16000)
    runs = (["--est_dir", str(d), "--metrics", "stoi,sisnr,erle,snr,pesq",
             "--allow-approx-pesq"],
            ["--est", str(d / "0_near_est.wav"), "--ref", str(d / "0_near.wav"), "--mic",
             str(d / "0_mic.wav")])
    for args in runs:
        out = {}
        for name, main in (("jax", jmeasure.main), ("port", measure.main)):
            main([*args, "--json_out", str(tmp_path / f"{name}.json")])
            with open(str(tmp_path / f"{name}.json")) as f:
                out[name] = json.load(f)
        capsys.readouterr()
        assert out["port"].keys() == out["jax"].keys()
        pairs = [(out["port"]["mean"], out["jax"]["mean"])]
        pairs += list(zip(out["port"]["utterances"], out["jax"]["utterances"]))
        for got, want in pairs:
            assert got.keys() == want.keys()
            for key, w in want.items():
                if isinstance(w, float):
                    assert abs(got[key] - w) <= 1e-5 * max(1.0, abs(w)), key
                else:
                    assert got[key] == w, key
    with pytest.raises(SystemExit, match="allow-approx-pesq"):
        measure.main(["--est_dir", str(d), "--metrics", "pesq"])


def test_pt_files_cross_both_ways(tmp_path):
    """A ``.pt`` from JAX's save_reference_checkpoint loads in the port, the
    port's in JAX's; the state dicts (DSP buffers included) equal JAX's for
    LittleNet and for DCCRN's v1 and v2 layouts; export_pt of either package
    loads in the other."""
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3)))
    net = load_npz(CKPT, device="cpu")
    want_sd = jtc.state_dict_from_little_net_params(params_to_jax(net))
    got_sd = torch_compat.state_dict_from_little_net_params(net)
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert got_sd[k].dtype == want_sd[k].dtype
        np.testing.assert_array_equal(got_sd[k], want_sd[k], err_msg=k)

    jpt = str(tmp_path / "jax.pt")
    jtc.save_reference_checkpoint(jpt, {"cur_epoch": 7}, {
        k: torch.from_numpy(np.array(v)) for k, v in jtc.state_dict_from_little_net_params(
            params).items()})
    info, state = torch_compat.load_reference_checkpoint(jpt)
    assert info == {"cur_epoch": 7}
    got = params_to_jax(torch_compat.little_net_params_from_state_dict(state, device="cpu"))
    for a in params:
        for b in params[a]:
            np.testing.assert_array_equal(got[a][b], params[a][b])

    ppt = str(tmp_path / "port.pt")
    torch_compat.save_reference_checkpoint(ppt, {"cur_iter": 4}, {
        k: torch.from_numpy(v) for k, v in got_sd.items()})
    info, state = jtc.load_reference_checkpoint(ppt)
    assert info == {"cur_iter": 4}
    back = jtc.little_net_params_from_state_dict(state)
    mine = params_to_jax(net)
    for a in mine:
        for b in mine[a]:
            np.testing.assert_array_equal(np.asarray(back[a][b]), mine[a][b])

    # export_pt: the JAX CLI's file in the port and the port's in JAX
    npz = str(tmp_path / "m.npz")
    jck.save(npz, {"params": params}, ckpt_info={"cur_epoch": 2, "cur_iter": 9})
    for name, main, load in (("jax", jexport.main, torch_compat.load_reference_checkpoint),
                             ("port", export_pt.main, jtc.load_reference_checkpoint)):
        out = str(tmp_path / f"exp_{name}.pt")
        main(["--model_file", npz, "--out", out])
        info, state = load(out)
        assert info == {"cur_epoch": 2, "cur_iter": 9}, name
        assert state.keys() == want_sd.keys()
        np.testing.assert_array_equal(state["gru1.weight_hh_l0"], params["gru"]["w_hh"])

    for kw in (dict(use_clstm=False, use_cbn=False, v2_head=False), {}):
        cfg = td.DccrnConfig(conv_channels=(4, 8, 16), rnn_layers=1, **kw)
        p, s = td.dccrn_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        got = torch_compat.state_dict_from_dccrn_params(p, s)
        want = jtc.state_dict_from_dccrn_params(*jax.tree.map(lambda t: t.numpy(), (p, s)))
        assert got.keys() == want.keys() and got, kw
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_infer_on_a_pt_equals_the_npz_run(tmp_path, tt_list):
    """cli/infer with a ``.pt`` written by export_pt from an ``.npz``: every
    wav bit-equal to the ``.npz`` run's (Kalman stage 1, CPU)."""
    pt = str(tmp_path / "m.pt")
    export_pt.main(["--model_file", CKPT, "--out", pt])
    for tag, model in (("npz", CKPT), ("pt", pt)):
        infer.main(["--tt_list", tt_list, "--ckpt_dir", str(tmp_path / f"exp_{tag}"),
                    "--model_file", model, "--est_path", str(tmp_path / tag), "--stage1",
                    "kalman", "--device", "cpu"])
    names = sorted(os.listdir(str(tmp_path / "npz" / "test")))
    assert len(names) == 15 and names == sorted(os.listdir(str(tmp_path / "pt" / "test")))
    for fn in names:
        a = read_wav(str(tmp_path / "npz" / "test" / fn))[0]
        b = read_wav(str(tmp_path / "pt" / "test" / fn))[0]
        np.testing.assert_array_equal(a, b, err_msg=fn)


def test_profile_counts_equal_jax(capsys):
    """Every family: ``params``, ``param_mb`` and ``reference`` equal to
    JAX's (its counts from the shapes of its init, jax.eval_shape);
    ``flops_per_call`` is torch's count, positive and not held to XLA's."""
    profile.main(["--n", "2048"])
    rows = json.loads(capsys.readouterr().out)
    assert [r["model"] for r in rows] == list_models()
    for row in rows:
        spec = jax_model(row["model"])
        shapes = jax.eval_shape(spec.init, jax.random.PRNGKey(0))
        want = jax_num_params(shapes[0] if spec.stateful else shapes)  # params, not state
        assert row["params"] == want, row["model"]
        assert row["param_mb"] == round(want * 4 / 2**20, 3)
        assert row["reference"] == spec.reference
        assert row["flops_per_call"] > 0
        assert row["flops_per_sample"] == row["flops_per_call"] / 2048


def test_profiling_utilities(tmp_path):
    """flops: FlopCounterMode's count of a matmul (2 m n k), bytes not
    counted; timed: a positive median; trace: a Chrome trace file."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    cost = profiling.flops(torch.matmul, a, b)
    assert cost["flops"] == 2 * 8 * 16 * 4 and np.isnan(cost["bytes_accessed"])
    assert profiling.timed(torch.matmul, a, b, iters=3) > 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.matmul(a, b)
    with open(str(tmp_path / "tr" / "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_new_clis_import_no_jax():
    """Every CLI and module of this slice imports and answers ``--help``
    with jax and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        "import aec_tpu_torch.pipeline.features, aec_tpu_torch.pipeline.segment_loader\n"
        "import aec_tpu_torch.pipeline.device_cache, aec_tpu_torch.train.pesq\n"
        "import aec_tpu_torch.utils.torch_compat, aec_tpu_torch.utils.profiling\n"
        "import importlib\n"
        "for name in ('prepare_data', 'batch_enhance', 'stream', 'measure', 'export_pt',\n"
        "             'profile', 'infer', 'train'):\n"
        "    try:\n"
        "        importlib.import_module('aec_tpu_torch.cli.' + name).main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, name\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.path.abspath(REPO),
                              "OMP_NUM_THREADS": "1"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
