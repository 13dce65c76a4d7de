"""Where the warp-owned stage-1 step spends its time, on the card: K6 and K7
on one utterance, and K1 on a batch of them.

    python -m aec_tpu_torch.kernels.single_costs [--reps 5] [--batch 1 256]

The step is ``csrc/stage1_warp.cuh``'s, which ``csrc/single_stream.cu`` (K6,
K7) and ``csrc/kalman_batched.cu`` (K1) share. Builds both sources into
``_build/single_costs/`` as they are and with parts of the step cut out
(:data:`VARIANTS`): without the constraint's transforms
(``-DAEC_NO_CONSTRAINT_FFT``: each partition's job keeps its gradient,
pre-split, split and update), and without the echo synthesis and residual
transforms (``-DAEC_NO_ECHO_FFT``); and once with ``clock64()`` marks at the
step's phase boundaries (:func:`clocked`, text inserted into a copy of the
header, as ``kernels/phase_costs.py`` cuts K2), which read each phase's
cycles for warp 0 (phase 2's echo transforms, then job 0) and warp 1 (phase
2's analysis of the next block, then job 1) of the first CTA. Runs K6 and K7 at the default geometry (L = 10, block 256)
on one 8.2 s utterance, the shape of their launches on the scenes, and K1
on ``--batch`` such utterances at once (above the SMs' count two CTAs share
an SM, and the first CTA's phases show it). Prints each variant's ms (CUDA
events, the median of ``--reps`` calls, the card idle before each) and µs
per step, the phases' cycles and µs per step, ptxas's registers and spills
for the default instantiations and, for K1, the CTAs an SM holds, beside
the card's name and power limit. A cut variant's outputs are meaningless;
only its time is read. ``chip_smoke.py`` prints the same through
:func:`start_build`, :func:`finish_build` and :func:`costs`.

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.fft_plan import radix_plan
from aec_tpu_torch.kernels.kalman import bind_batched, bind_single, launch_batched, launch_single
from aec_tpu_torch.kernels.lstm_costs import registers
from aec_tpu_torch.kernels.serving_costs import call_ms

VARIANTS = {"full": [], "no_constraint_fft": ["-DAEC_NO_CONSTRAINT_FFT"],
            "no_echo_fft": ["-DAEC_NO_ECHO_FFT"], "clocks": []}
# the sources that run the step, and how each build is bound
SOURCES = {"single_stream": bind_single, "kalman_batched": bind_batched}
HEADER = "stage1_warp.cuh"
N = 131072  # one 8.2 s utterance at 16 kHz: 512 blocks of 256
# the default instantiations' mangled names: FixedGeom<256, 10, 32>, FixedPlan<8, 8, 4>
GEOM_PLAN = ("FixedGeomILi256ELi10ELi32E", "FixedPlanIJLi8ELi8ELi4E")
# the phases the clocked build marks, in the order of a step
PHASES = ("estimate", "barrier A", "phase 2", "barrier B", "gain", "barrier C", "jobs", "stores",
          "barrier D")
# (text in stage1_warp.cuh, what the clocked build puts in its place): a
# mark adds the cycles since the last one to its phase
_MARKS = (
    ("  const float inv_n = 1.f / F;\n",
     "  const float inv_n = 1.f / F;\n"
     "  long long ck[9] = {0}, c0 = clock64();\n"
     "  const bool rec = blockIdx.x == 0 && (tid == 0 || tid == 32);\n"
     "#define MARK(i) if (rec) { const long long c_ = clock64(); ck[i] += c_ - c0; c0 = c_; }\n"),
    ("      if (lane == 0) s.red[warp] = sum;\n    }\n    __syncthreads();\n",
     "      if (lane == 0) s.red[warp] = sum;\n    }\n    MARK(0) __syncthreads(); MARK(1)\n"),
    ("      analysis(t + 1, 1);\n    }\n    __syncthreads();\n",
     "      analysis(t + 1, 1);\n    }\n    MARK(2) __syncthreads(); MARK(3)\n"),
    ("      }\n    }\n    __syncthreads();\n\n    // 4. jobs",
     "      }\n    }\n    MARK(4) __syncthreads(); MARK(5)\n\n    // 4. jobs"),
    ("    if (tid < B) {\n      far_of(t + 2)[tid] = fx;",
     "    MARK(6) if (tid < B) {\n      far_of(t + 2)[tid] = fx;"),
    ("    if (t + 1 < t_blocks) fetch(t + 1);\n    __syncthreads();\n  }\n}\n",
     "    if (t + 1 < t_blocks) fetch(t + 1);\n    MARK(7) __syncthreads(); MARK(8)\n  }\n"
     "  if (rec) for (int i = 0; i < 9; ++i) aec_clocks[tid / 32][i] = ck[i];\n}\n"),
    ("template <bool kNlms, class G, class Plan>\n__device__",
     "__device__ long long aec_clocks[2][9];\n\ntemplate <bool kNlms, class G, class Plan>\n"
     "__device__"),
)
# what each clocked source gets appended: an entry that copies the cycles out
_READ_CLOCKS = ('\nextern "C" int aec_read_clocks(long long* h) {\n'
                "  return cudaMemcpyFromSymbol(h, aec_clocks, sizeof(aec_clocks));\n}\n")


def clocked(text: str) -> str:
    """stage1_warp.cuh with the phase marks (:data:`_MARKS`): warps 0 and 1
    of the first CTA add up their cycles per phase over the steps of a
    launch into ``aec_clocks``."""
    for old, new in _MARKS:
        if text.count(old) != 1:
            raise ValueError(f"{HEADER} no longer has one {old!r}: update _MARKS")
        text = text.replace(old, new)
    return text


def start_build() -> dict:
    """Start compiling every variant of both sources, one ``nvcc`` each, all
    at once; :func:`finish_build` waits for them. The clocked variant
    compiles copies of the sources beside its copy of the header, which
    their ``#include`` then finds first."""
    procs = {}
    for variant, defines in VARIANTS.items():
        d = _build.BUILD / "single_costs" / variant
        d.mkdir(parents=True, exist_ok=True)
        if variant == "clocks":
            (d / HEADER).write_text(clocked((_build.CSRC / HEADER).read_text()))
        for name in SOURCES:
            src = _build.CSRC / f"{name}.cu"
            if variant == "clocks":
                src = d / f"{name}.cu"
                src.write_text((_build.CSRC / f"{name}.cu").read_text() + _READ_CLOCKS)
            out = d / f"lib{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
                   str(out), str(src)]
            procs[variant, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict[str, dict[str, tuple[ctypes.CDLL, str]]]:
    """{variant: {source: (bound library, nvcc's log)}} of
    :func:`start_build`'s compiles."""
    libs: dict = {}
    for (variant, name), (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({variant}):\n{log}")
        libs.setdefault(variant, {})[name] = (SOURCES[name](ctypes.CDLL(str(out))), log)
    return libs


def _read_clocks(lib: ctypes.CDLL, steps: int) -> dict:
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * len(PHASES)))()
    _build.check(lib.aec_read_clocks(buf), "single_costs clocks")
    return {f"warp {w}": {p: buf[w * len(PHASES) + i] / steps for i, p in enumerate(PHASES)}
            for w in (0, 1)}


def costs(libs, reps: int, seed: int = 0, batches: tuple[int, ...] = ()) -> list[dict]:
    """K6 and K7 on one 8.2 s utterance, and K1 on each batch of ``batches``
    such utterances, whole and cut, and their phases."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    width = max((1, *batches))
    far = torch.randn(width, N, generator=g, device=dev)
    mic = 0.5 * far + 0.01 * torch.randn(width, N, generator=g, device=dev)
    mhz = torch.cuda.get_device_properties(dev).clock_rate / 1e3
    steps = N // 256
    out = []

    def row(name, shape, log, kernel, run):
        r = {"kernel": name, "shape": shape, "registers": registers(log, kernel, *GEOM_PLAN),
             "ms": {}, "mhz": mhz}
        for variant, built in libs.items():
            if variant != "clocks":
                r["ms"][variant] = call_ms(lambda: run(built), reps)
        r["us_per_step"] = {v: ms / steps * 1e3 for v, ms in r["ms"].items()}
        run(libs["clocks"])
        return r

    for name, cfg, nlms in (("K6", KalmanConfig(), "ILb0E"), ("K7", NlmsConfig(), "ILb1E")):
        def run(built, cfg=cfg):
            return launch_single(cfg, far[0], mic[0], 256, built["single_stream"][0])
        r = row(name, f"L = {cfg.n_blocks}, block 256, {steps} blocks",
                libs["full"]["single_stream"][1], "single_fft_kernel" + nlms, run)
        r["cycles"] = _read_clocks(libs["clocks"]["single_stream"][0], steps)
        out.append(r)
    cfg, plan = KalmanConfig(), radix_plan(256)
    for batch in batches:
        f, m = far[:batch].contiguous(), mic[:batch].contiguous()
        e = torch.empty_like(m)

        def run(built, f=f, m=m, e=e):
            return launch_batched(cfg, f, m, e, 256, False, built["kalman_batched"][0])
        r = row("K1", f"batch {batch}, L = {cfg.n_blocks}, block 256, {steps} blocks",
                libs["full"]["kalman_batched"][1], "kalman_batched_kernel_warp", run)
        r["cycles"] = _read_clocks(libs["clocks"]["kalman_batched"][0], steps)
        r["ctas_an_sm"] = libs["full"]["kalman_batched"][0].aec_kalman_warp_ctas(
            256, cfg.n_blocks, (ctypes.c_int * len(plan))(*plan), len(plan), dev.index)
        out.append(r)
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    steps = ", ".join(f"{v} {ms:.3f} ms = {row['us_per_step'][v]:.2f} us" for v, ms in
                      row["ms"].items())
    phases = "; ".join(f"{w}: " + ", ".join(f"{p} {c:.0f}" for p, c in cyc.items())
                       for w, cyc in row["cycles"].items())
    total = sum(row["cycles"]["warp 0"].values())
    ctas = f"; {row['ctas_an_sm']} CTAs an SM" if "ctas_an_sm" in row else ""
    return (f"{row['kernel']} {row['shape']}: a call and a step, whole and cut: {steps}; cycles "
            f"a step by phase ({phases}; warp 0's sum {total:.0f} = {total / row['mhz']:.2f} us "
            f"at {row['mhz']:.0f} MHz, marks included); ptxas {row['registers']}{ctas}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, nargs="*", default=[1, 256],
                    help="K1's batches of 8.2 s utterances")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("single_costs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = finish_build(start_build())
    with torch.no_grad():
        for row in costs(libs, args.reps, batches=tuple(args.batch)):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
