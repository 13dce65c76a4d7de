"""Where the steps of K9 and K10 spend their time, on the card.

    python -m aec_tpu_torch.kernels.lstm_costs [--reps 5]

Builds ``csrc/lstm.cu`` (K9) and ``csrc/lstm_int8.cu`` (K10) into
``_build/lstm_costs/`` as they are and with parts cut out (:data:`VARIANTS`):
without the dots (``-DAEC_NO_DOTS``), which leaves a step's barrier, h's
exchange through L2 and the cells; without the dots' L2 part; with
cooperative groups' grid barrier in place of the counters; K10 also with
its L2 part streamed from one CTA's chunks. Runs each at its path's shape (K9: DCCRN's two groups at
H = 1024 over T = 513 frames, B = 1 and 16; K10: ATT-CCRN's H = 4096,
T = 513, B = 1) on one input and prints its ms (CUDA events, the median of
``--reps`` calls, the card idle before each), its µs per step, the plan's
bytes of weights a CTA holds in registers and in shared memory and reads
from L2 each step, and ptxas's registers and spills for the instantiation
that ran, beside the card's name and power limit. A cut variant's outputs
are meaningless; only its time is read. ``chip_smoke.py`` prints the same
through :func:`start_build`, :func:`finish_build` and :func:`costs`.

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels import lstm as k9
from aec_tpu_torch.kernels import lstm_int8 as k10
from aec_tpu_torch.kernels.serving_costs import call_ms
from aec_tpu_torch.ops.lstm import quantize_rows_int8

# each source as it is, and cut: without its dots (-DAEC_NO_DOTS: the step's
# exchange of h and its cells), without the dots' L2 part (-DAEC_NO_L2), with
# cooperative groups' grid barrier at the end of each step (-DAEC_GRID_SYNC);
# K9 also with its per-group counter at every R (-DAEC_COUNTER: by default
# only past 8 rows), K10 with every CTA streaming CTA 0's L2 chunks, which are
# then L2-resident for certain (-DAEC_L2_HOT)
_CUTS = {"full": [], "no_dots": ["-DAEC_NO_DOTS"], "no_l2": ["-DAEC_NO_L2"],
         "grid_sync": ["-DAEC_GRID_SYNC"]}
VARIANTS = {"lstm": {**_CUTS, "counter": ["-DAEC_COUNTER"]},
            "lstm_int8": {**_CUTS, "l2_hot": ["-DAEC_L2_HOT"]}}
T_STEPS = 513  # frames of one 8.2 s utterance at hop 256


def start_build() -> dict:
    """Start compiling both sources in both variants, one ``nvcc`` each, all
    at once; :func:`finish_build` waits for them."""
    root = _build.BUILD / "lstm_costs"
    procs = {}
    for src, variants in VARIANTS.items():
        for variant, defines in variants.items():
            out = root / f"{src}_{variant}" / "lib.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
                   str(out), str(_build.CSRC / f"{src}.cu")]
            procs[src, variant] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict[tuple[str, str], tuple[ctypes.CDLL, str]]:
    """{(source, variant): (bound library, nvcc's log)} of
    :func:`start_build`'s compiles."""
    libs = {}
    for (src, variant), (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src} ({variant}):\n{log}")
        module = k9 if src == "lstm" else k10
        libs[src, variant] = (module.bind(ctypes.CDLL(str(out))), log)
    return libs


def registers(log: str, *kernel: str) -> str:
    """ptxas's registers and spill line for the instantiation whose mangled
    name contains every string of ``kernel``."""
    spill, hit = "", False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            hit = all(k in line for k in kernel)
        elif hit and "spill" in line:
            spill = line.strip()
        elif hit and "registers" in line:
            return f"{line.split(':', 1)[1].strip()}; {spill}"
    return "not found"


def _k9_case(dev, b: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = ((torch.rand(2, 4096, 1024, generator=g) * 2 - 1) / 32).to(dev)
    xp = torch.randn(2, 2 * b, T_STEPS, 4096, generator=g).to(dev)
    return xp, w


def _k10_case(dev, seed: int):
    g = torch.Generator().manual_seed(seed)
    w_q, scale = quantize_rows_int8(torch.randn(16384, 4096, generator=g) / 64)
    xp = torch.randn(1, T_STEPS, 16384, generator=g)
    zeros = torch.zeros(1, 4096)
    return [t.to(dev) for t in (xp, w_q, scale / 127.0, 0.1 * torch.randn(16384, generator=g),
                                zeros, zeros)]


def costs(libs, reps: int, seed: int = 0) -> list[dict]:
    """Each kernel at its path's shape, whole and cut."""
    dev = torch.device("cuda", 0)
    stream = _build.stream_of(torch.empty(0, device=dev))
    out = []
    for b in (1, 16):
        xp, w = _k9_case(dev, b, seed)
        plan = k9.card_plan(2, 2 * b, 1024, dev)
        packed = k9.packed_weights([w], plan)
        rt = min(2 * b, 8, 32 // plan.cw)
        rt = 1 << (rt - 1).bit_length()
        row = {"kernel": "K9", "shape": f"B = {b}, R = {2 * b}, H = 1024, 2 groups, T = {T_STEPS}",
               "split": plan.split(), "ctas": plan.ctas,
               "registers": registers(libs["lstm", "full"][1], f"lstm_kernelILi{plan.cw}ELi{rt}E"),
               "ms": {}}
        for variant in VARIANTS["lstm"]:
            lib = libs["lstm", variant][0]
            row["ms"][variant] = call_ms(lambda: k9.launch(lib, plan, xp, packed, 0, stream), reps)
        out.append(row)
        del xp, w, packed
    args = _k10_case(dev, seed)
    plan = k10.card_plan(4096, 1, dev)
    row = {"kernel": "K10", "shape": f"B = 1, H = 4096, T = {T_STEPS}", "split": plan.split(),
           "ctas": plan.ctas, "ms": {},
           "registers": registers(libs["lstm_int8", "full"][1],
                                  f"lstm_int8_kernelILi{plan.rpw}ELi1E")}
    for variant in VARIANTS["lstm_int8"]:
        lib = libs["lstm_int8", variant][0]
        row["ms"][variant] = call_ms(lambda: k10.launch(lib, plan, *args, 0, stream), reps)
    out.append(row)
    for r in out:
        r["us_per_step"] = {v: ms / T_STEPS * 1e3 for v, ms in r["ms"].items()}
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    kb = {k: f"{v / 1024:.0f} KB" for k, v in row["split"].items()}
    steps = ", ".join(f"{v} {ms:.3f} ms = {row['us_per_step'][v]:.2f} us" for v, ms in
                      row["ms"].items())
    return (f"{row['kernel']} {row['shape']}: a call and a step, whole and cut: {steps}; weights "
            f"a CTA ({row['ctas']} CTAs): registers {kb['registers']}, shared {kb['shared']}, "
            f"from L2 each step {kb['l2']}; ptxas {row['registers']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_costs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = finish_build(start_build())
    with torch.no_grad():
        for row in costs(libs, args.reps):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
