"""K2, LittleNet over a batch (``csrc/stage2.cu``, its GRU phase on K8):
operations and bytes of its FFT formulation, as ``chip_smoke.py``'s
``stage2_bounds`` and ``stage2_fft_flops`` count them."""

from __future__ import annotations

import numpy as np

from aec_bench.counts.fft import SPLIT_FLOPS, complex_fft_flops
from aec_bench.reference.dsp import erb_matrix


def erb_terms(cfg: dict) -> int:
    """The ERB matrix's nonzero weights: the projections count only these."""
    e = erb_matrix(cfg["stft"]["win"] // 2 + 1, cfg["erb"]["bands"], cfg["erb"]["max_freq"])
    return int(np.count_nonzero(e.astype(np.float32)))


def frame_flops(cfg: dict) -> int:
    """One LittleNet frame of one utterance: 2 forward real FFTs of 2B points
    (windowed) and 1 inverse (windowed); magnitudes; the ERB projections over
    the matrix's support, the gain over it and gain times spectrum; the GRU's
    input and hidden projections and cell; lin1 and lin2; the overlap-add."""
    block, bands = cfg["stft"]["hop"], cfg["erb"]["bands"]
    cfft, k, nz = complex_fft_flops(block), block + 1, erb_terms(cfg)
    fft = 2 * (cfft + SPLIT_FLOPS * k + 2 * block) + cfft + SPLIT_FLOPS * block + 2 * block
    small = 2 * (2 * nz + nz + 12 * bands * bands) + 2 * k + 12 * bands
    return fft + 5 * 2 * k + small + 3 * block


def consts_bytes(cfg: dict) -> int:
    """Window, twiddles, the ERB matrix and its transpose, the weights."""
    win, k, bands = cfg["stft"]["win"], cfg["stft"]["win"] // 2 + 1, cfg["erb"]["bands"]
    return 4 * (2 * win + 2 * k * bands + 12 * bands * bands)


def count(cfg: dict, utterances: int, samples: int, launches: int) -> tuple[float, float]:
    """(flops, bytes) over ``utterances`` of ``samples`` in ``launches``
    calls: stage-1 output and far end in, wav out, the mask out."""
    frames = samples // cfg["stft"]["hop"] + 1
    nbytes = 3 * 4 * utterances * samples + 4 * utterances * frames * cfg["erb"]["bands"]
    return (float(utterances * frames * frame_flops(cfg)),
            float(nbytes + launches * consts_bytes(cfg)))
