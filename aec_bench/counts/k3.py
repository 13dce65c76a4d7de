"""K3, one two-stage hop for S streams (``csrc/serving.cu`` on ``csrc/hop.cuh``):
operations and bytes, as ``chip_smoke.py``'s ``serving_bounds`` counts them."""

from __future__ import annotations

from aec_bench.counts import k1, k2


def hop_flops(cfg: dict) -> int:
    """One hop of one stream: K1's FFT step and one LittleNet frame."""
    return k1.step_flops(cfg["stft"]["hop"], cfg["kalman"]["n_blocks"]) + k2.frame_flops(cfg)


def state_bytes(cfg: dict) -> int:
    """A stream's state: W's parts, P and the far ring (L, K) each, psi, four
    blocks of samples, the GRU state and the 8 monitor rows."""
    parts, k, hop = cfg["kalman"]["n_blocks"], cfg["stft"]["hop"] + 1, cfg["stft"]["hop"]
    return 4 * (5 * parts * k + k + 4 * hop + cfg["erb"]["bands"] + 8)


def count(cfg: dict, ticks: int, streams: int) -> tuple[float, float]:
    """(flops, bytes) of ``ticks`` one-hop calls of ``streams`` streams: far
    and mic in, out, the state read and written once, the constants."""
    hop = cfg["stft"]["hop"]
    per_call = (3 * 4 * streams * hop + 2 * streams * state_bytes(cfg)
                + 4 * cfg["stft"]["win"] + k2.consts_bytes(cfg))
    return float(ticks * streams * hop_flops(cfg)), float(ticks * per_call)
