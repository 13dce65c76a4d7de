"""The port's parallel entry points on two gloo ranks, end to end, as JAX's
tests/test_distributed.py drives its own: ``cli/train --mesh`` in two
processes on a corpus packed by the port's ``prepare_data``,
``cli/batch_enhance --mesh`` in two processes against the run without
``--mesh``, and ``parallel.dryrun.dryrun_multichip(2)``. The CLI processes
block jax and the JAX package; one intra-op thread each."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.train import checkpoints as jck
from aec_tpu_torch.cli import batch_enhance, prepare_data
from aec_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
from aec_tpu_torch.pipeline.audio_io import read_wav, write_wav

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT = os.path.join(REPO, "checkpoints", "little_net_general.npz")
RUN_S = 240  # each process, start to finish


def _rank_procs(argv: list[str], module: str, world: int = 2) -> list[subprocess.Popen]:
    """``world`` processes running ``module``'s main(argv) as the ranks of one
    group (AEC_*), jax and the JAX package blocked."""
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
            f"from {module} import main\n"
            f"main({argv!r})\n")
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             "AEC_COORDINATOR": f"127.0.0.1:{port}", "AEC_NUM_PROCESSES": str(world),
             "AEC_PROCESS_ID": str(r)}) for r in range(world)]


def _finish(procs: list[subprocess.Popen]) -> list[str]:
    """Each process's output; a process past RUN_S is killed and fails."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RUN_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """4 utterances of 8192 samples packed by prepare_data (train and test);
    both CLIs started on two ranks each, then the dry run, then the
    single-process batch_enhance, while the CLI ranks run."""
    work = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(7)
    wav_dir, h5_dir, lists = (str(work / d) for d in ("wavs", "h5", "lists"))
    os.makedirs(wav_dir)
    for i in range(4):
        n = 8192
        far = rng.standard_normal(n).astype(np.float32)
        rir = (np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
        echo = np.convolve(far, 0.3 * rir)[:n].astype(np.float32)
        near = (0.2 * rng.standard_normal(n)).astype(np.float32)
        for key, x in (("nearend_speech", near), ("nearend_mic", near + echo),
                       ("farend_speech", far), ("echo", echo)):
            write_wav(os.path.join(wav_dir, f"{key}_fileid_{i:03d}.wav"), x, 16000)
    for split in ("train", "test"):
        prepare_data.main([split, "--wav_path", wav_dir, "--h5_path", h5_dir,
                           "--list_path", lists])
    exp = str(work / "exp")
    train = _rank_procs(["--tr_list", os.path.join(lists, "tr_list.txt"), "--cv_file",
                         os.path.join(h5_dir, "test.ex"), "--ckpt_dir", exp, "--batch_size",
                         "2", "--max_n_epochs", "1", "--mesh", "--device", "cpu"],
                        "aec_tpu_torch.cli.train")
    # batches of 3 and 1: each padded to the two ranks
    bulk = ["--tt_list", os.path.join(lists, "tt_list.txt"), "--model_file", CKPT,
            "--batch", "3", "--bucket", "4096", "--device", "cpu"]
    meshed = _rank_procs(bulk + ["--out_dir", str(work / "meshed"), "--mesh"],
                         "aec_tpu_torch.cli.batch_enhance")
    try:
        dry = dryrun_multichip(2, device="cpu", timeout=RUN_S)
        batch_enhance.main(bulk + ["--out_dir", str(work / "single")])
    finally:
        train_out, meshed_out = _finish(train), _finish(meshed)
    return {"work": work, "exp": exp, "train": train_out, "meshed": meshed_out, "dry": dry}


def test_train_mesh_two_processes(runs):
    """cli/train --mesh on two ranks: each brings its group up from AEC_*;
    both log the same losses (train.log, where every rank logs); only rank
    0 writes the checkpoints and metrics (one metrics line for the one
    period); the checkpoint restores in JAX."""
    for r, out in enumerate(runs["train"]):
        assert f"torch.distributed up: process {r}/2, backend gloo" in out, out[-2000:]
    with open(os.path.join(runs["exp"], "train.log")) as f:
        epochs = [line.split("] ", 1)[1] for line in f if "tr_loss:" in line]
    assert len(epochs) == 2 and epochs[0] == epochs[1], epochs
    with open(os.path.join(runs["exp"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 1
    latest = os.path.join(runs["exp"], "models", "latest.npz")
    restored = jck.restore(latest, {"params": jax_init(jax.random.PRNGKey(0))})
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree.leaves(restored["params"]))


def test_batch_enhance_mesh_two_processes(runs):
    """cli/batch_enhance --mesh --batch 3 on two ranks (both batches padded)
    writes, from rank 0 alone, the files of the run without --mesh: each
    wav within 1e-4 of its scale (the bar tests/test_torch_cli.py holds the
    CLI to against JAX's) and the report's counts."""
    reports = [[json.loads(line) for line in out.splitlines() if line.startswith("{")]
               for out in runs["meshed"]]
    assert len(reports[0]) == 1 and reports[1] == [] and reports[0][0]["utterances"] == 4
    for k in range(4):
        got = read_wav(str(runs["work"] / "meshed" / f"{k}_enhanced.wav"))[0]
        want = read_wav(str(runs["work"] / "single" / f"{k}_enhanced.wav"))[0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k


def test_dryrun_multichip_two_ranks(runs):
    """The dry run's surfaces on two gloo ranks: finite losses equal on both
    ranks, the pipelined scan's finals replicated, the TP LSTM within 2e-6
    of the dense scan, ATT-CCRN's wav the same on both ranks; K3's plain
    version on the CPU (no launch)."""
    a, b = runs["dry"]
    assert a["backend"] == "gloo" and a["loss"] == b["loss"]
    assert a["dccrn_loss"] == b["dccrn_loss"]
    np.testing.assert_array_equal(a["pipelined_finals"], b["pipelined_finals"])
    assert max(a["tp_lstm_err"], b["tp_lstm_err"]) <= 2e-6
    np.testing.assert_allclose(a["att_ccrn_wav"], b["att_ccrn_wav"], atol=1e-6)
    assert a["k3_launches"] == b["k3_launches"] == 0
