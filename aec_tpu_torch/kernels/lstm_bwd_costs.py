"""Where K9b's time goes: the LSTM backward at the training paths' shapes
under each warp layout its plan can take.

    python -m aec_tpu_torch.kernels.lstm_bwd_costs [--reps 5]

For DCCRN's complex-LSTM layer (2 groups x 32 rows x 501 steps, H = 1024,
plan (b)) and FullSubNet's sub band (16 x 161 rows x 801 steps, H = 96,
plan (a)) and full band (16 rows, H = 256, plan (b)), K9b is launched at
its default plan and at every other columns-a-warp (``cw``) the layout
takes (``lstm_bwd.backward_plan(cw=...)``): each line gives the plan, the
kernel's ms (``serving_costs.call_ms``: CUDA events, the card idle before
each call, median of ``--reps``) and its max|d| from the default plan's
dxp over dxp's scale. If one layout's time stands apart, the dots' pattern
(which warps share a staged quad, how many sweeps re-read W) bounds the
step; if all stand together, the step's serial parts do (the staging
rounds, the barriers, the cells' loads, the exchange).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from aec_tpu_torch.kernels import lstm_bwd
from aec_tpu_torch.kernels.serving_costs import call_ms

# (path, G, B, F, T, H): G groups of B x F rows, T steps
SHAPES = (("dccrn", 2, 32, 1, 501, 1024), ("fullsubnet_sub_band", 1, 16, 161, 801, 96),
          ("fullsubnet_full_band", 1, 16, 1, 801, 256))


def costs(reps: int, seed: int = 0) -> list[dict]:
    """One row a (shape, layout): the plan's fields, ms, err."""
    dev = torch.device("cuda", 0)
    rows = []
    for name, g, b, f, t, h in SHAPES:
        gen = torch.Generator().manual_seed(seed)
        w = [((torch.rand(4 * h, h, generator=gen) * 2 - 1) / h ** 0.5).to(dev) for _ in range(g)]
        g_ys = torch.randn(g, b, t, f, h, generator=gen).to(dev)
        saved = torch.rand(g, b, t, f, 5 * h, generator=gen).to(dev)
        default = lstm_bwd.card_plan(g, b * f, h, dev)
        ref = lstm_bwd.launch(default, g_ys, saved, w)
        scale = float(ref.abs().max())
        for cw in (16, 8, 4, 2, 1):
            try:
                plan = lstm_bwd.card_plan(g, b * f, h, dev, cw=cw)
                out = lstm_bwd.launch(plan, g_ys, saved, w)
            except ValueError:  # no layout of cw columns a warp, or no room for it
                continue
            err = float((out - ref).abs().max()) / scale
            ms = call_ms(lambda: lstm_bwd.launch(plan, g_ys, saved, w), reps)
            rows.append({"path": name, "default": plan == default, "ms": ms, "err": err,
                         **{k: getattr(plan, k) for k in ("units", "nchunk", "runs", "cw",
                                                          "ks", "npos", "jreg", "jsm", "stage")}})
            del out
        del g_ys, saved, ref
    return rows


def report(row: dict) -> str:
    plan = ", ".join(f"{k} {row[k]}" for k in ("units", "nchunk", "runs", "cw", "ks", "npos",
                                               "jreg", "jsm", "stage"))
    return (f"K9b {row['path']}{' (default plan)' if row['default'] else ''}: {plan}: "
            f"{row['ms']:.3f} ms, max|d| from the default plan {row['err']:.2e} of scale")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_bwd_costs: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with torch.no_grad():
        for row in costs(args.reps):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
