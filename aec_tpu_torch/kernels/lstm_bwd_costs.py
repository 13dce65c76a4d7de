"""Where K9b's step goes: the LSTM backward at the training paths' shapes,
whole and with parts of its step cut out.

    python -m aec_tpu_torch.kernels.lstm_bwd_costs [--reps 5] [--plans]

Builds ``csrc/lstm_bwd.cu`` into ``_build/lstm_bwd_costs/`` as it is and
with one part of the step cut out (:data:`VARIANTS`, each a macro the
source reads and no route defines), each build holding only the kernels
of the plans it times (``-DAEC_KEEP``, :func:`keep_mask`):

- ``no_dots`` (``-DAEC_NO_DOTS``): the products of dxp(t + 1) with W_hh;
- ``no_stage`` (``-DAEC_NO_STAGE``): the staging of dxp(t + 1) into shared
  memory (the grid plan's TMA copies; the dots then run on whatever the
  buffers hold);
- ``no_wait`` (``-DAEC_NO_WAIT``): the waits for the group's other CTAs'
  dxp(t + 1) (the grid plan's flags);
- ``no_cells`` (``-DAEC_NO_CELLS``): the cells and dxp(t)'s stores (the
  inputs still stream in).

The cluster plan's exchange (bulk-copy pushes and their mbarrier waits)
goes in every cut variant (its cells, where kept, store into the own slot):
a push without its wait, or a wait without its push, would not end.

Runs each at DCCRN's complex-LSTM layer (2 groups x 32 rows x 501 steps,
H = 1024), FullSubNet's sub band (16 x 161 rows x 801 steps, H = 96) and
full band (16 rows x 801 steps, H = 256), at the route's plan
(``lstm_bwd.card_plan``), on one random input, and prints its ms (CUDA
events, the card idle before each call, median of ``--reps``), µs a step
and ptxas's registers and spills for the kernel, beside the card's name and
power limit. A cut variant's output is meaningless; only its time is read:
what a part costs is the whole's time less the variant's. ``chip_smoke.py``
prints the same (phases 22 and 24) through :func:`start_build`,
:func:`finish_build` and :func:`costs`.

With ``--plans`` it times, in turns, the route's build at other plans of
the same shapes (:func:`plan_variants`): DCCRN's layer on the split plan
and on the grid plan at 4, 8 and 16 columns a warp, rounds of 2 rows
through 2 buffers or of 4 rows through one; the sub band at 8 or 16
columns a warp; the full band as one cluster of 16 CTAs of 16 units at 4
or 8 columns a warp or of 8 CTAs of 32, or split over 16 CTAs. These are
the numbers the plan's choices rest on (PERF.md §6).

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import time

import torch

from aec_tpu_torch.kernels import _build, lstm_bwd
from aec_tpu_torch.kernels.serving_costs import call_ms

VARIANTS = {"full": [], "no_dots": ["-DAEC_NO_DOTS"], "no_stage": ["-DAEC_NO_STAGE"],
            "no_wait": ["-DAEC_NO_WAIT"], "no_cells": ["-DAEC_NO_CELLS"]}
# (path, G, B, F, T, H): G groups of B x F rows, T steps
SHAPES = (("dccrn", 2, 32, 1, 501, 1024), ("fullsubnet_sub_band", 1, 16, 161, 801, 96),
          ("fullsubnet_full_band", 1, 16, 1, 801, 256))


def instantiation(plan: lstm_bwd.BackwardPlan) -> tuple[int, int, int]:
    """(mode, columns a warp, rows a sweep) of the kernel ``plan`` launches,
    as ``csrc/lstm_bwd.cu``'s ``bwd_launch_cw`` picks the rows a sweep: 1
    for one row, 2 for the grid plan's 2-row rounds (where 32 / CW > 2),
    else min(32 / CW, 8); the split plan's kernel has no rows a sweep (1)."""
    mode = lstm_bwd.MODES.index(plan.mode)
    if plan.mode == "split":
        return mode, plan.cw, 1
    sweep = plan.round_rows if plan.mode == "grid" else plan.block_rows
    cap = min(32 // plan.cw, 8)
    rt = 1 if sweep <= 1 else 2 if plan.mode == "grid" and cap > 2 and sweep <= 2 else cap
    return mode, plan.cw, rt


def keep_mask(sms: int, smem_optin: int) -> int:
    """The ``AEC_KEEP`` mask of the instantiations :func:`costs` launches on
    a card of ``sms`` SMs and ``smem_optin`` bytes of shared memory a CTA:
    the three shapes' plans at every cluster width ``card_plan`` may narrow
    to (bit mode * 20 + log2(cw) * 4 + log2(rt), the split plan's 60 +
    log2(cw))."""
    bits = 0
    for _, g, b, f, _, h in SHAPES:
        for widest in range(lstm_bwd.MAX_CLUSTER, 1, -1):
            mode, cw, rt = instantiation(lstm_bwd.backward_plan(
                g, b * f, h, sms, smem_optin, max_cluster=widest))
            lg_cw, lg_rt = cw.bit_length() - 1, rt.bit_length() - 1
            bits |= 1 << (60 + lg_cw if mode == lstm_bwd.MODES.index("split")
                          else mode * 20 + lg_cw * 4 + lg_rt)
    return bits


def start_build() -> dict:
    """Start compiling every variant, one ``nvcc`` each, all at once, each
    holding only the instantiations :func:`costs` launches on this card
    (:func:`keep_mask`; the route's build holds all); :func:`finish_build`
    waits for them."""
    root = _build.BUILD / "lstm_bwd_costs"
    props = torch.cuda.get_device_properties(0)
    mask = keep_mask(props.multi_processor_count, props.shared_memory_per_block_optin)
    keep = f"-DAEC_KEEP={mask:#x}ULL"
    procs = {}
    for variant, defines in VARIANTS.items():
        out = root / variant / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, keep, "-I", str(_build.CSRC), "-o",
               str(out), str(_build.CSRC / "lstm_bwd.cu")]
        procs[variant] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (bound library, nvcc's log)} of :func:`start_build`'s compiles."""
    libs = {}
    for variant, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for lstm_bwd ({variant}):\n{log}")
        libs[variant] = (lstm_bwd.bind(ctypes.CDLL(str(out))), log)
    return libs


def registers(log: str) -> list[str]:
    """ptxas's registers and spill lines of every kernel in the log."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def case(g: int, b: int, f: int, t: int, h: int, dev, seed: int):
    """One shape's inputs: W_hh in [-1, 1] / sqrt(H), g_ys normal, the
    saved gates and c uniform in [0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    w = [((torch.rand(4 * h, h, generator=gen) * 2 - 1) / h ** 0.5).to(dev) for _ in range(g)]
    g_ys = torch.randn(g, b, t, f, h, generator=gen).to(dev)
    saved = torch.rand(g, b, t, f, 5 * h, generator=gen).to(dev)
    return g_ys, saved, w


def costs(libs, reps: int, seed: int = 0) -> list[dict]:
    """One row a shape: the plan, ms and µs a step of each variant."""
    dev = torch.device("cuda", 0)
    rows = []
    for name, g, b, f, t, h in SHAPES:
        g_ys, saved, w = case(g, b, f, t, h, dev, seed)
        plan = lstm_bwd.card_plan(g, b * f, h, dev)
        ms = {v: call_ms(lambda lib=lib: lstm_bwd.launch(plan, g_ys, saved, w, lib), reps)
              for v, (lib, _) in libs.items()}
        rows.append({"path": name, "steps": t, "plan": plan.describe(), "ms": ms,
                     "us_per_step": {v: m / t * 1e3 for v, m in ms.items()}})
        del g_ys, saved, w
    return rows


def _replan(plan: lstm_bwd.BackwardPlan, **fields) -> lstm_bwd.BackwardPlan:
    """``plan`` with ``fields`` replaced and its shared memory recounted."""
    p = dataclasses.replace(plan, **fields)
    return dataclasses.replace(p, smem=lstm_bwd.plan_smem(
        p.mode, p.hidden, p.run_rows, p.block_rows, p.units, p.nchunk, p.cw, p.ks, p.jsm,
        p.round_rows, p.nbuf))


def plan_variants(reps: int, seed: int = 0) -> list[tuple[str, str, list[float]]]:
    """(path, the plan, its ms in two turns) for the route's build at the
    plans the module's docstring lists, the route's own first."""
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    sms, optin = props.multi_processor_count, props.shared_memory_per_block_optin
    out = []
    for name, g, b, f, t, h in SHAPES:
        g_ys, saved, w = case(g, b, f, t, h, dev, seed)
        route = lstm_bwd.card_plan(g, b * f, h, dev)
        plans = [route]
        if name == "dccrn":
            for cw in (4, 8, 16):
                p0 = lstm_bwd._plan("grid", g, b * f, h, sms, optin, cw=cw)
                plans += [_replan(p0, nbuf=nbuf, round_rows=rr_) for nbuf, rr_ in ((2, 2), (1, 4))]
        elif name == "fullsubnet_sub_band":
            plans += [lstm_bwd._plan("local", g, b * f, h, sms, optin, cw=cw) for cw in (8, 16)]
        else:
            plans += [lstm_bwd._plan("cluster", g, b * f, h, sms, optin, cw=8),
                      lstm_bwd._plan("cluster", g, b * f, h, sms, optin, max_cluster=8),
                      lstm_bwd._plan("split", g, b * f, h, sms, optin)]
        plans = [p for i, p in enumerate(plans) if p.smem <= optin and p not in plans[:i]]
        ms = {p: [] for p in plans}
        for order in (plans, plans[::-1]):
            for p in order:
                try:
                    ms[p].append(call_ms(lambda p=p: lstm_bwd.launch(p, g_ys, saved, w), reps))
                except (RuntimeError, ValueError):  # a plan the kernel refuses: no time
                    ms[p].append(float("nan"))
        out += [(name, p.describe(), ms[p]) for p in plans]
        del g_ys, saved, w
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    parts = ", ".join(f"{v} {ms:.3f} ms = {row['us_per_step'][v]:.2f} us" for v, ms in
                      row["ms"].items())
    return f"K9b {row['path']} ({row['steps']} steps; {row['plan']}): whole and cut: {parts}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plans", action="store_true", help="also time other plans (route's build)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_bwd_costs: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = finish_build(start_build())
    kernels = registers(libs["full"][1])
    print(f"K9b cost variants: {len(libs)} built in {time.perf_counter() - t0:.1f} s, "
          f"{len(kernels)} kernels each [{smi}]", flush=True)
    for line in kernels:
        print(f"K9b ptxas {line}", flush=True)
    with torch.no_grad():
        for row in costs(libs, args.reps):
            print(f"{report(row)} [{smi}]", flush=True)
        if args.plans:
            for name, plan, ms in plan_variants(args.reps):
                print(f"K9b {name} at {plan}: {', '.join(f'{m:.3f}' for m in ms)} ms [{smi}]",
                      flush=True)


if __name__ == "__main__":
    main()
