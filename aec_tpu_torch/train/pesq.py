"""PESQ (ITU-T P.862 / P.862.2 wideband): the from-spec reimplementation of
``aec_tpu/train/pesq.py``, numpy and scipy only, the same numbers.

The reference's metric CLI intended pesq+stoi
(`Stage2_lhm/scripts/utils/measure.py:5`, `run_evaluate.sh:16-19`) but is
syntactically broken and imports missing modules (SURVEY §2.3). No licensed
ITU implementation ships with the package, so:

1. :func:`pesq` — an OPT-IN, from-the-published-spec reimplementation of
   the P.862 perceptual model producing MOS-LQO via the P.862.1/.2 maps;
2. :func:`pesq_available` / the ``cli.measure --metrics pesq`` hook prefer
   an external reference implementation (``import pesq``, the pypi wrapper
   of the ITU ANSI-C code) whenever one is installed, and fall back to (1)
   only with an explicit ``allow_fallback``.

DEVIATION RISK — read before citing numbers: this is a structural
reimplementation written from the spec text, NOT the ITU ANSI-C reference,
and it has no conformance validation against the P.862 test vectors.
Known simplifications, each documented at the code site:

- time alignment is global (envelope cross-correlation + fine search)
  rather than the spec's per-utterance splitting/realignment — adequate for
  AEC outputs, which are produced time-aligned by construction;
- the input filters are analytic approximations (100 Hz Butterworth-style
  high-pass for wideband per P.862.2; IRS-like band-pass for narrowband)
  rather than the spec's tabulated FIR/IIR coefficients;
- the Bark decomposition uses 49 bands spaced uniformly in a standard
  Bark warp (7*asinh(f/650)) with analytic absolute-threshold and
  loudness-scaling curves, rather than the ITU code's fixed tables.

Scores therefore correlate with, but do not exactly equal, reference PESQ
(expect same ordering, offsets up to a few tenths of MOS). Treat the output
as "P.862-structured objective MOS", not certified PESQ.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import butter, lfilter

# perceptual-model constants (P.862 §10; analytic stand-ins documented above)
N_BARK = 49
# Overall loudness scaling. The ITU value is Sl=1.855e-1 on the ITU table's
# power scale; with this module's ANALYTIC threshold curve the equivalent
# operating point was re-calibrated on a white-noise SNR ladder so the
# MOS-LQO curve lands in the published ballpark (speech-like clean ref:
# clean 4.64 / 30 dB 4.5 / 20 dB 4.1 / 10 dB 2.6 / 0 dB 1.6).
SLL = 5.565e-1
ZWICKER_POWER = 0.23
D_WEIGHT = 0.1  # raw-score weight of the symmetric disturbance (P.862 §10.4)
DA_WEIGHT = 0.0309  # weight of the asymmetric disturbance


def pesq_available() -> bool:
    """True iff an external reference PESQ implementation is importable."""
    try:
        import pesq as _pesq  # noqa: F401

        return hasattr(_pesq, "pesq")
    except Exception:
        return False


def pesq_external(ref: np.ndarray, deg: np.ndarray, sr: int = 16000) -> float:
    """Score with the external (ITU-wrapper) implementation. Raises
    ImportError when none is installed — callers gate on pesq_available()."""
    import pesq as _pesq

    mode = "wb" if sr == 16000 else "nb"
    return float(_pesq.pesq(sr, np.asarray(ref), np.asarray(deg), mode))


# --------------------------------------------------------------------------
# from-spec model
# --------------------------------------------------------------------------


def _bandpass_power(x: np.ndarray, sr: int, lo=350.0, hi=3250.0) -> float:
    b, a = butter(2, [lo / (sr / 2), hi / (sr / 2)], btype="band")
    y = lfilter(b, a, x)
    return float(np.mean(y * y) + 1e-20)


def _level_align(x: np.ndarray, sr: int) -> np.ndarray:
    """Scale to the spec's fixed target power measured over the speech band
    (P.862 §10.1.2: both signals are scaled to a constant power computed
    over 350-3250 Hz)."""
    # internal listening level: ~40 dB above this module's analytic
    # threshold curve in the speech bands (the spec pins 79 dB SPL against
    # the ITU threshold TABLE; scale and curve must be calibrated jointly —
    # see the SLL comment)
    target = 1e11 / 16384.0
    return x * np.sqrt(target / _bandpass_power(x, sr))


def _input_filter(x: np.ndarray, sr: int, mode: str) -> np.ndarray:
    if mode == "wb":
        # P.862.2: IRS is replaced by a flat response above 100 Hz
        b, a = butter(4, 100.0 / (sr / 2), btype="high")
        return lfilter(b, a, x)
    # narrowband: IRS-receive-like band-pass (analytic approximation)
    b, a = butter(2, [300.0 / (sr / 2), 3100.0 / (sr / 2)], btype="band")
    return lfilter(b, a, x)


def _align(ref: np.ndarray, deg: np.ndarray, sr: int, max_delay_s=0.5):
    """Global time alignment: coarse 4 ms-envelope cross-correlation, then a
    fine full-band search around the coarse lag. (Spec deviation: no
    utterance splitting — see module docstring.)"""
    hop = int(0.004 * sr)
    n = min(len(ref), len(deg)) // hop * hop
    er = np.sqrt(np.mean(ref[:n].reshape(-1, hop) ** 2, axis=1))
    ed = np.sqrt(np.mean(deg[:n].reshape(-1, hop) ** 2, axis=1))
    max_lag = int(max_delay_s * sr / hop)
    lags = np.arange(-max_lag, max_lag + 1)
    xc = [
        float(
            np.dot(
                er[max(0, -L) : len(er) - max(0, L)],
                ed[max(0, L) : len(ed) - max(0, -L)],
            )
        )
        for L in lags
    ]
    coarse = int(lags[int(np.argmax(xc))]) * hop
    # fine: +-one envelope hop around the coarse lag
    best, best_v = coarse, -np.inf
    for L in range(coarse - hop, coarse + hop + 1, max(hop // 16, 1)):
        a = ref[max(0, -L) : len(ref) - max(0, L)]
        b = deg[max(0, L) : len(deg) - max(0, -L)]
        m = min(len(a), len(b))
        v = float(np.dot(a[:m], b[:m]))
        if v > best_v:
            best, best_v = L, v
    if best > 0:
        deg = deg[best:]
    elif best < 0:
        ref = ref[-best:]
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def _bark_hz(z):
    return 650.0 * np.sinh(np.asarray(z) / 7.0)


def _hz_bark(f):
    return 7.0 * np.arcsinh(np.asarray(f) / 650.0)


@functools.lru_cache(maxsize=4)
def _bark_fb(sr: int, nfft: int):
    """(N_BARK, nfft//2+1) averaging matrix + band widths in Bark + band
    centre frequencies. Uniform partition of the Bark axis up to sr/2."""
    f = np.linspace(0.0, sr / 2.0, nfft // 2 + 1)
    z_max = float(_hz_bark(sr / 2.0))
    edges_z = np.linspace(0.0, z_max, N_BARK + 1)
    edges_f = _bark_hz(edges_z)
    fb = np.zeros((N_BARK, len(f)))
    for i in range(N_BARK):
        sel = (f >= edges_f[i]) & (f < edges_f[i + 1])
        if not sel.any():
            sel[np.argmin(np.abs(f - 0.5 * (edges_f[i] + edges_f[i + 1])))] = True
        fb[i, sel] = 1.0 / sel.sum()
    widths = np.diff(edges_z)
    centres = 0.5 * (edges_f[:-1] + edges_f[1:])
    return fb, widths, centres


def _abs_threshold(centres_hz: np.ndarray) -> np.ndarray:
    """Absolute hearing threshold per band (power units on the internal
    scale) — analytic ISO-226-shaped stand-in for the spec table."""
    f = np.maximum(centres_hz, 20.0) / 1000.0
    thr_db = (
        3.64 * f**-0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f**4
    )
    return 10.0 ** (thr_db / 10.0)


def _loudness(p_bands: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """Zwicker loudness per band (P.862 §10.2.5):
    S = Sl * (thr/0.5)^g * [ (0.5 + 0.5 P/thr)^g - 1 ]; 0 below threshold."""
    g = ZWICKER_POWER
    s = SLL * (thr / 0.5) ** g * ((0.5 + 0.5 * p_bands / thr) ** g - 1.0)
    return np.where(p_bands > thr, np.maximum(s, 0.0), 0.0)


def pesq(
    ref: np.ndarray,
    deg: np.ndarray,
    sr: int = 16000,
    mode: str | None = None,
) -> float:
    """From-spec P.862 objective MOS-LQO (see module docstring for the
    deviation risk). ``mode``: "wb" (default at 16 kHz) or "nb"."""
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if mode is None:
        mode = "wb" if sr >= 16000 else "nb"
    if min(len(ref), len(deg)) < sr // 2:
        raise ValueError("pesq needs at least 0.5 s of audio")

    ref = _level_align(_input_filter(ref, sr, mode), sr)
    deg = _level_align(_input_filter(deg, sr, mode), sr)
    ref, deg = _align(ref, deg, sr)

    # 32 ms Hann frames, 50% overlap (P.862 §10.2.1)
    nfft = 512 if sr == 16000 else 256
    hop = nfft // 2
    n_frames = (len(ref) - nfft) // hop + 1
    if n_frames < 4:
        raise ValueError("pesq needs at least 4 analysis frames")
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nfft)[None, :]
    win = np.hanning(nfft)
    spec_r = np.abs(np.fft.rfft(ref[idx] * win, axis=1)) ** 2
    spec_d = np.abs(np.fft.rfft(deg[idx] * win, axis=1)) ** 2

    fb, widths, centres = _bark_fb(sr, nfft)
    pr = spec_r @ fb.T  # (T, N_BARK) pitch-power densities
    pd = spec_d @ fb.T
    thr = _abs_threshold(centres) * nfft  # internal power scale

    # speech-active frames of the reference (P.862 uses a frame threshold
    # relative to the absolute threshold; here: >1e4 x mean silence floor)
    frame_pow = pr.sum(axis=1)
    active = frame_pow > frame_pow.max() * 1e-4
    if active.sum() < 2:
        active[:] = True

    # partial frequency compensation of the REFERENCE towards the degraded
    # spectrum (P.862 §10.2.3; clipped to +-20 dB)
    num = (pd[active] + 1000.0).mean(axis=0)
    den = (pr[active] + 1000.0).mean(axis=0)
    ratio = np.clip(num / den, 10.0 ** (-2.0), 10.0**2.0)
    pr_eq = pr * ratio[None, :]

    # short-term gain compensation of the DEGRADED signal (P.862 §10.2.4;
    # bounded, first-order smoothed)
    g = (pr_eq.sum(axis=1) + 5e3) / (pd.sum(axis=1) + 5e3)
    g = np.clip(g, 3e-4, 5.0)
    g_s = np.empty_like(g)
    prev = 1.0
    for t in range(len(g)):
        prev = 0.8 * prev + 0.2 * g[t]
        g_s[t] = prev
    pd_eq = pd * g_s[:, None]

    lr = _loudness(pr_eq, thr[None, :])
    ld = _loudness(pd_eq, thr[None, :])

    # disturbance with masking deadzone (P.862 §10.3.1)
    m = 0.25 * np.minimum(lr, ld)
    d = np.maximum(np.abs(ld - lr) - m, 0.0)

    # asymmetry factor (P.862 §10.3.2): added distortion weighs more
    h = ((pd_eq + 50.0) / (pr_eq + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))

    w = widths[None, :]
    d_frame = np.sqrt(np.sum(w * d * d, axis=1) / w.sum())  # L2 over bands
    da_frame = np.sum(w * d * h, axis=1) / w.sum()

    # loudness-dependent de-emphasis + clip (P.862 §10.3.3)
    tot_loud = lr.sum(axis=1)
    emph = ((tot_loud + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / emph, 45.0)
    da_frame = np.minimum(da_frame / emph, 45.0)

    def _time_agg(x):
        # L6 over ~320 ms syllables (50% overlap), then L2 over syllables
        # (P.862 §10.4)
        step, size = 10, 20
        chunks = [
            (np.mean(x[s : s + size] ** 6.0)) ** (1.0 / 6.0)
            for s in range(0, max(len(x) - size, 1), step)
        ] or [float(np.mean(x**6.0) ** (1.0 / 6.0))]
        return float(np.sqrt(np.mean(np.square(chunks))))

    d_sym = _time_agg(d_frame[active])
    d_asym = _time_agg(da_frame[active])

    raw = 4.5 - D_WEIGHT * d_sym - DA_WEIGHT * d_asym
    if mode == "wb":
        # P.862.2 MOS-LQO map
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    # P.862.1 MOS-LQO map
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))


def pesq_score(
    ref: np.ndarray,
    deg: np.ndarray,
    sr: int = 16000,
    *,
    allow_fallback: bool = False,
) -> dict:
    """The measure-CLI hook: prefer an external reference implementation,
    fall back to the from-spec model only when explicitly allowed.

    Returns {"pesq": float, "pesq_impl": "external"|"p862_from_spec"}.
    Raises RuntimeError when no external implementation exists and the
    fallback was not opted into.
    """
    if pesq_available():
        return {"pesq": pesq_external(ref, deg, sr), "pesq_impl": "external"}
    if not allow_fallback:
        raise RuntimeError(
            "No external PESQ implementation installed (pip package `pesq`). "
            "Pass --allow-approx-pesq to use the bundled from-spec "
            "reimplementation (uncertified; see aec_tpu_torch/train/pesq.py)."
        )
    return {"pesq": pesq(ref, deg, sr), "pesq_impl": "p862_from_spec"}
