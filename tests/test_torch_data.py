"""Port data pipeline == JAX, on the CPU: ``pipeline/h5io.pack_train_dir``,
``cli/prepare_data`` (train, test, val), ``pipeline/segment_loader`` and
``pipeline/features``; and the h5py stand-in ``chip_smoke.py`` uses on a
machine without h5py."""

import os
import sys

import h5py
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from aec_tpu.cli import prepare_data as jprep
from aec_tpu.dsp.erb import erb_filterbank as jerb
from aec_tpu.pipeline import features as jfeat
from aec_tpu.pipeline import h5io as jh5
from aec_tpu.pipeline import segment_loader as jseg
from aec_tpu_torch.cli import prepare_data
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.pipeline import features, h5io, segment_loader
from aec_tpu_torch.pipeline.audio_io import write_wav


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Three wav quadruples of unequal length (one not a hop multiple)."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(3)
    for fid, n in ((0, 8192), (1, 6000), (7, 8192)):
        far = (0.5 * rng.standard_normal(n)).astype(np.float32)
        echo = (0.3 * np.convolve(far, np.exp(-np.arange(64) / 16.0))[:n]).astype(np.float32)
        near = (0.2 * rng.standard_normal(n)).astype(np.float32)
        for key, x in (("nearend_speech", near), ("nearend_mic", near + echo),
                       ("farend_speech", far), ("echo", echo)):
            write_wav(str(d / f"{key}_fileid_{fid}.wav"), x, 16000)
    return str(d)


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _lines(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_prepare_data_matches_jax(tmp_path, wav_dir, split):
    """Each split writes JAX's files, lists and datasets: the same names,
    the same arrays; list entries differ only by the output root."""
    roots = {}
    for name, main in (("jax", jprep.main), ("port", prepare_data.main)):
        root = str(tmp_path / name)
        main([split, "--wav_path", wav_dir, "--h5_path", os.path.join(root, "h5"),
              "--list_path", os.path.join(root, "lists")])
        roots[name] = root
    lists = sorted(os.listdir(os.path.join(roots["jax"], "lists")))
    assert lists == sorted(os.listdir(os.path.join(roots["port"], "lists"))) and lists
    for lst in lists:
        want = _lines(os.path.join(roots["jax"], "lists", lst)).replace(roots["jax"], "ROOT")
        got = _lines(os.path.join(roots["port"], "lists", lst)).replace(roots["port"], "ROOT")
        assert got == want, lst
    for dirpath, _, files in os.walk(os.path.join(roots["jax"], "h5")):
        for fn in files:
            mine = os.path.join(dirpath.replace(roots["jax"], roots["port"]), fn)
            want, got = _h5_tree(os.path.join(dirpath, fn)), _h5_tree(mine)
            assert sorted(got) == sorted(want) and want, fn
            for k in want:
                assert got[k].dtype == want[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fn}:{k}")


def test_pack_train_dir_matches_jax(tmp_path, wav_dir):
    got = h5io.pack_train_dir(wav_dir, str(tmp_path / "p"), str(tmp_path / "p" / "l.txt"))
    want = jh5.pack_train_dir(wav_dir, str(tmp_path / "j"), str(tmp_path / "j" / "l.txt"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "tr_0.ex", "tr_1.ex", "tr_7.ex"]
    for a, b in zip(got, want):
        for k, v in jh5.read_utterance(b).items():
            np.testing.assert_array_equal(h5io.read_utterance(a)[k], v)


@pytest.fixture(scope="module")
def seg_corpus(tmp_path_factory):
    """Four train-layout files (8192 and 3000 samples: one shorter than a
    segment) and a grouped val-layout file of three."""
    d = tmp_path_factory.mktemp("seg")
    rng = np.random.default_rng(5)
    files = []
    for i, n in enumerate((8192, 3000, 8192, 6500)):
        p = str(d / f"tr_{i}.ex")
        h5io.write_utterance(p, {k: rng.standard_normal(n).astype(np.float32)
                                 for k in h5io.TRAIN_KEYS})
        files.append(p)
    val = str(d / "val.ex")
    h5io.write_grouped(val, [{k: rng.standard_normal(n).astype(np.float32)
                              for k in h5io.VAL_KEYS} for n in (8192, 5000, 7000)],
                       keys=h5io.VAL_KEYS)
    return files, val


@pytest.mark.parametrize("layout", ["train", "val"])
def test_segment_loader_gives_jax_batches_in_jax_order(seg_corpus, layout):
    """4000-sample segments, 1000-sample shift, batch 3, normalized and
    shuffled: the same batches in the same order over two epochs."""
    files, val = seg_corpus
    src = files if layout == "train" else val
    kw = dict(segment_size=0.25, segment_shift=0.0625, batch_size=3, seed=11)
    mine, theirs = segment_loader.SegmentLoader(src, **kw), jseg.SegmentLoader(src, **kw)
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    utt = {"mic": np.arange(1.0, 6.0)}
    assert segment_loader.split_segments(utt, 8, 2)[0]["n_samples"] == 5
    np.testing.assert_array_equal(segment_loader.normalize_utt(utt)["mic"],
                                  jseg.normalize_utt(utt)["mic"])


def test_extract_features_match_jax():
    """Every feature tensor within 1e-5 of its scale; the chunked driver
    (chunk 2 over 3 rows) returns numpy equal to the one-shot call."""
    rng = np.random.default_rng(9)
    mic, ref, near = (rng.standard_normal((3, 4096)).astype(np.float32) for _ in range(3))
    want = jfeat.extract_features(*map(jnp.asarray, (mic, ref, near, jerb())))
    got = features.extract_features(*map(torch.from_numpy, (mic, ref, near, erb_filterbank())))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5 * float(np.abs(w).max()),
                                   rtol=0, err_msg=k)
    chunked = features.extract_features_chunked(mic, ref, near, chunk=2, device="cpu")
    jchunked = jfeat.extract_features_chunked(mic, ref, near, chunk=2)
    for k in want:
        assert isinstance(chunked[k], np.ndarray)
        np.testing.assert_array_equal(chunked[k], got[k].numpy(), err_msg=k)
        np.testing.assert_allclose(chunked[k], jchunked[k],
                                   atol=1e-5 * float(np.abs(jchunked[k]).max()), rtol=0)


def test_h5_stand_in_round_trips_through_h5io(tmp_path, monkeypatch):
    """chip_smoke.py runs the file paths on a machine without h5py through
    an npz-backed stand-in of the h5py calls h5io makes: what h5io writes
    through it reads back bit for bit, in both layouts."""
    monkeypatch.setitem(sys.modules, "h5py", chip_smoke.npz_h5py())
    rng = np.random.default_rng(2)
    utts = [{k: rng.standard_normal(n).astype(np.float32) for k in h5io.TRAIN_KEYS}
            for n in (300, 200)]
    one, grp = str(tmp_path / "one.ex"), str(tmp_path / "grp.ex")
    h5io.write_utterance(one, utts[0])
    assert h5io.write_grouped(grp, utts) == 2
    assert h5io.utterance_length(one) == 300 and h5io.group_count(grp) == 2
    for k, v in h5io.read_utterance(one).items():
        np.testing.assert_array_equal(v, utts[0][k])
    for k, v in h5io.read_group(grp, 1).items():
        np.testing.assert_array_equal(v, utts[1][k])
