"""K13's bound and where its step goes: the many-row LSTM layer at
FullSubNet's published sub band, beside cuDNN's LSTM on the same rows.

    python -m aec_tpu_torch.kernels.lstm_rows_costs [--reps 5] [--rows 2048] [--frames 503]

The bound (:func:`bound`). A CTA owns 16 rows and every unit, so a step is
16 x 4H x H FMAs a CTA and W_hh's 16 H^2 bytes read from L2 into each CTA
(``csrc/lstm_rows.cu``'s header). At H = 384 and 2,048 rows (128 CTAs, one
an SM): 9.4 M FMA a CTA, 37.2 us a step at the SM's 128 FMA a clock and
1.98 GHz, and 302 MB a step from L2, 54.9 us at the 5.5 TB/s assumed for
the H100's L2 reads (no tool here measures it): the L2 read bounds a step,
then the FMAs. The card's roofline (the benchmark's ``counts/k13.py``: the
FMAs over 67 TFLOP/s against the tensors over 3.35 TB/s) is the FMA side
summed over the card, 18.1 ms a layer.

Times, by CUDA events, the card idle before each call, median of
``--reps`` in turns: K13's forward saving the gates, its backward, and
cuDNN's ``nn.LSTM`` (one layer, the same rows as its batch, TF32 off)
forward and backward; prints ms, µs a step and each against its bound,
beside the card's name and power limit. Needs the card and ``nvcc``; a
measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from aec_tpu_torch.kernels import lstm_rows
from aec_tpu_torch.kernels.serving_costs import call_ms

SMS, CLOCK_HZ, FMA_CLOCK = 132, 1.98e9, 128  # H100 SXM: SMs, boost clock, fp32 FMA a clock an SM
L2_READ = 5.5e12  # bytes/s, the L2's read rate assumed for the H100 (not measured here)


def bound(rows: int, hidden: int) -> dict:
    """µs a step of K13 by its FMAs (the CTAs in waves over the SMs) and by
    W_hh's reads from L2, and the step's bound, the larger."""
    ctas = -(-rows // lstm_rows.ROWS_CTA)
    waves = -(-ctas // SMS)
    fma = lstm_rows.ROWS_CTA * 4 * hidden * hidden
    fma_us = 1e6 * waves * fma / FMA_CLOCK / CLOCK_HZ
    l2_us = 1e6 * ctas * 16 * hidden * hidden / L2_READ
    return {"ctas": ctas, "fma_us": fma_us, "l2_us": l2_us, "step_us": max(fma_us, l2_us)}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def costs(rows: int, frames: int, hidden: int, inputs: int, reps: int) -> dict:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    lstm = torch.nn.LSTM(inputs, hidden, batch_first=True).to(dev)
    w_hh = lstm.weight_hh_l0.detach()
    x = torch.rand(rows, frames, inputs, generator=g, device=dev)
    xp = (x @ lstm.weight_ih_l0.detach().T).contiguous()
    g_ys = torch.randn(rows, frames, hidden, generator=g, device=dev) * 1e-3
    _, saved = lstm_rows.rows_recurrence(xp, w_hh, save=True)
    xg = x.clone().requires_grad_(True)

    def cudnn_fwd():
        with torch.no_grad():
            lstm(x)

    def cudnn_bwd_prep():
        ys, _ = lstm(xg)
        return ys

    calls = {"k13_fwd": lambda: lstm_rows.rows_recurrence(xp, w_hh, save=True),
             "k13_bwd": lambda: lstm_rows.rows_backward(g_ys, saved, w_hh),
             "cudnn_fwd": cudnn_fwd}
    times = {k: [] for k in (*calls, "cudnn_bwd")}
    for _ in range(reps):
        for name, fn in calls.items():
            times[name].append(call_ms(fn, 1))
        ys = cudnn_bwd_prep()
        times["cudnn_bwd"].append(call_ms(
            lambda: torch.autograd.grad(ys, [xg], g_ys, retain_graph=True), 1))
    b = bound(rows, hidden)
    out = {"card": card(), "rows": rows, "frames": frames, "hidden": hidden, "bound": b}
    for name, ts in times.items():
        ms = statistics.median(ts)
        out[name] = {"ms": ms, "us_step": 1e3 * ms / frames, "of_bound": 1e3 * ms / frames
                     / b["step_us"]}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=503)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--inputs", type=int, default=384)
    args = ap.parse_args(argv)
    print(json.dumps(costs(args.rows, args.frames, args.hidden, args.inputs, args.reps)))


if __name__ == "__main__":
    main()
