"""The model flops of ``dccrn``: convolutions, the LSTMs' projections and
recurrences, counted from the configuration's shapes whatever implements
them; a training step counts the backward at twice the forward."""

from __future__ import annotations


def shapes(cfg: dict, samples: int) -> dict:
    net = cfg["net"]
    hop = cfg["stft"]["hop"]
    frames = samples // hop + 1
    bins = cfg["stft"]["win"] // 2  # the DC bin dropped
    chans = net["conv_channels"]
    bottom = bins // net["stride"][0] ** (len(chans) - 1)
    # "hidden" is the LSTMs' width per part (I = H): half the channels by the bottom bins
    return {"frames": frames, "bins": bins, "chans": chans, "bottom": bottom,
            "hidden": chans[-1] // 2 * bottom, "kernel": net["kernel"][0] * net["kernel"][1]}


def conv_fma(cfg: dict, batch: int, samples: int) -> float:
    """Encoder convs at their output grid and decoder transposed convs at
    their input grid, each Cin x Cout x kernel FMA a point (total channels,
    real and imaginary, which is the four real convs of a complex one)."""
    s = shapes(cfg, samples)
    chans, t, k = s["chans"], s["frames"], s["kernel"]
    fma, f = 0, s["bins"]
    for i in range(len(chans) - 1):
        f //= 2
        fma += batch * t * f * chans[i] * chans[i + 1] * k
    for i in range(len(chans) - 2, -1, -1):
        c_out = chans[i] if i > 0 else 2
        fma += batch * t * f * 2 * chans[i + 1] * c_out * k
        f *= 2
    return float(fma)


def lstm_fma(cfg: dict, batch: int, samples: int) -> float:
    """Per layer both LSTMs over both parts (4 passes): 4H I + 4H H a row-step."""
    s = shapes(cfg, samples)
    h = s["hidden"]
    per_layer = 2 * 2 * batch * s["frames"] * (4 * h * h + 4 * h * h)
    return float(per_layer * cfg["net"]["rnn_layers"])


def forward_flops(cfg: dict, batch: int, samples: int) -> float:
    return 2.0 * (conv_fma(cfg, batch, samples) + lstm_fma(cfg, batch, samples))


def train_step_flops(cfg: dict, batch: int, samples: int) -> float:
    return 3.0 * forward_flops(cfg, batch, samples)


def work_flops(cfg: dict, mix: dict, work: dict) -> float:
    """The model flops of a window's work: training steps, or utterances
    enhanced one at a time behind Kalman stage 1."""
    if "steps" in work:
        return work["steps"] * train_step_flops(cfg, work["batch"], work["samples"])
    from aec_bench.counts import k1

    per = forward_flops(cfg, 1, work["samples"]) + k1.count(cfg, 1, work["samples"])[0]
    return work["utterances"] * per
