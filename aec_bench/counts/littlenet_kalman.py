"""The model flops of ``littlenet_kalman`` on its FFT formulation (``PERF.md``'s
"The bounds"): Kalman stage 1 a block, LittleNet a frame."""

from __future__ import annotations

from aec_bench.counts import k1, k2, k3


def utterance_flops(cfg: dict, samples: int) -> float:
    hop = cfg["stft"]["hop"]
    steps, frames = samples // hop, samples // hop + 1
    return float(steps * k1.step_flops(hop, cfg["kalman"]["n_blocks"])
                 + frames * k2.frame_flops(cfg))


def hop_flops(cfg: dict) -> float:
    """One streamed hop of one stream (both stages)."""
    return float(k3.hop_flops(cfg))


def work_flops(cfg: dict, mix: dict, work: dict) -> float:
    """The model flops of a window's work: whole utterances (bulk) or
    streamed hops (serve)."""
    if "batches" in work:
        return work["batches"] * work["batch"] * utterance_flops(cfg, work["samples"])
    return work["ticks"] * work["streams"] * hop_flops(cfg)
