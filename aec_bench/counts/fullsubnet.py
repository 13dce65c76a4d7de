"""The model flops of ``fullsubnet``: both bands' LSTM layers (input and
recurrent products), the full band's linear and the head, counted from the
configuration's shapes whatever implements them; a training step counts
the backward at twice the forward and runs the sub band on drop band's
rows."""

from __future__ import annotations


def shapes(cfg: dict, batch: int, samples: int, groups: int) -> dict:
    """Frames with the look-ahead, bins, the sub band's rows (drop band's
    ``groups``; 1: every bin) and the bands' widths."""
    net = cfg["net"]
    f = net["num_freqs"]
    rows = batch * f if groups <= 1 else batch * ((f - f % groups) // groups)
    width = 2 * (2 * net["sb_num_neighbors"] + 1) + 2 * net["fb_num_neighbors"] + 1
    return {"frames": samples // cfg["stft"]["hop"] + 1 + net["look_ahead"], "bins": f,
            "rows": rows, "fb_hidden": net["fb_model_hidden_size"],
            "sb_hidden": net["sb_model_hidden_size"], "sb_input": width, "layers": net["layers"]}


def lstm_macs(inputs: int, hidden: int, layers: int) -> int:
    """A row-step of a stack of LSTM layers: 4H (I + H) a layer."""
    return sum(4 * hidden * ((inputs if n == 0 else hidden) + hidden) for n in range(layers))


def forward_flops(cfg: dict, batch: int, samples: int, groups: int) -> float:
    s = shapes(cfg, batch, samples, groups)
    t, f = s["frames"], s["bins"]
    fb = batch * t * (lstm_macs(f, s["fb_hidden"], s["layers"]) + s["fb_hidden"] * f)
    sb = s["rows"] * t * (lstm_macs(s["sb_input"], s["sb_hidden"], s["layers"])
                          + 2 * s["sb_hidden"])
    return 2.0 * (fb + sb)


def train_step_flops(cfg: dict, batch: int, samples: int, groups: int) -> float:
    return 3.0 * forward_flops(cfg, batch, samples, groups)


def work_flops(cfg: dict, mix: dict, work: dict) -> float:
    """The model flops of a window's training steps."""
    return work["steps"] * train_step_flops(cfg, work["batch"], work["samples"],
                                            cfg["net"]["num_groups_in_drop_band"])
