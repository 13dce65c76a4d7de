"""The port's from-spec PESQ (``train/pesq.py``) == JAX's
(``aec_tpu/train/pesq.py``) on 2 s clips, and the opt-in gating of
``pesq_score`` both ways: an external implementation is preferred when
installed, the from-spec model needs ``allow_fallback``."""

import sys
import types

import numpy as np
import pytest

from aec_tpu.train import pesq as jpesq
from aec_tpu_torch.train import pesq
from benchmarks.scenes import speech_like


@pytest.fixture(scope="module")
def clean():
    return speech_like(np.random.default_rng(0), 2 * 16000, f0=120.0, gain=0.3).astype(np.float64)


def _noisy(clean, snr_db, seed=1):
    noise = np.random.default_rng(seed).standard_normal(len(clean))
    noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2)) * 10 ** (-snr_db / 20)
    return clean + noise


def test_pesq_equals_jax(clean):
    """The same numbers (the same numpy and scipy code) on the pinned
    degradations of tests/test_pesq.py: identity, 20 and 5 dB noise,
    clipping, a bulk delay; and in narrowband mode at 8 kHz."""
    peak = float(np.abs(clean).max())
    cases = {
        "identity": clean,
        "snr20": _noisy(clean, 20),
        "snr5": _noisy(clean, 5),
        "clip": np.clip(clean, -0.4 * peak, 0.4 * peak),
        "delay": np.concatenate([np.zeros(640), clean])[: len(clean)],
    }
    scores = {}
    for name, deg in cases.items():
        scores[name] = pesq.pesq(clean, deg)
        assert scores[name] == jpesq.pesq(clean, deg), name
    assert scores["identity"] > scores["snr20"] > scores["snr5"]
    nb = clean[::2]
    assert pesq.pesq(nb, _noisy(nb, 10), sr=8000) == jpesq.pesq(nb, _noisy(nb, 10), sr=8000)
    with pytest.raises(ValueError, match="0.5 s"):
        pesq.pesq(clean[:4000], clean[:4000])


def test_pesq_score_gating(clean, monkeypatch):
    monkeypatch.setitem(sys.modules, "pesq", None)  # no external implementation
    assert not pesq.pesq_available()
    with pytest.raises(RuntimeError, match="allow-approx-pesq"):
        pesq.pesq_score(clean, clean)
    got = pesq.pesq_score(clean, _noisy(clean, 20), allow_fallback=True)
    assert got == {"pesq": pesq.pesq(clean, _noisy(clean, 20)), "pesq_impl": "p862_from_spec"}

    calls = []
    fake = types.SimpleNamespace(pesq=lambda sr, ref, deg, mode: calls.append((sr, mode)) or 3.25)
    monkeypatch.setitem(sys.modules, "pesq", fake)
    assert pesq.pesq_available()
    assert pesq.pesq_score(clean, clean) == {"pesq": 3.25, "pesq_impl": "external"}
    assert pesq.pesq_external(clean, clean, 8000) == 3.25
    assert calls == [(16000, "wb"), (8000, "nb")]
