"""Where the steps of K6 and K7 spend their time, on the card.

    python -m aec_tpu_torch.kernels.single_costs [--reps 5]

Builds ``csrc/single_stream.cu`` into ``_build/single_costs/`` as it is and
with parts cut out (:data:`VARIANTS`): without the constraint's transforms
(``-DAEC_NO_CONSTRAINT_FFT``: each partition's job keeps its gradient,
pre-split, split and update), and without the echo synthesis and residual
transforms (``-DAEC_NO_ECHO_FFT``); and once with ``clock64()`` marks at the
step's phase boundaries (:func:`clocked`, text inserted into a copy of the
source, as ``kernels/phase_costs.py`` cuts K2), which read each phase's
cycles for warp 0 (phase 2's transforms, then job 0) and warp 1 (job 1).
Runs K6 and K7 at the default geometry (L = 10, block 256) on one 8.2 s
utterance, the shape of their launches on the scenes, and prints each
variant's ms (CUDA events, the median of ``--reps`` calls, the card idle
before each) and µs per step, the phases' cycles and µs per step, and
ptxas's registers and spills for the default instantiations, beside the
card's name and power limit. A cut variant's outputs are meaningless; only
its time is read. ``chip_smoke.py`` prints the same through
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
from aec_tpu_torch.kernels.kalman import bind_single, launch_single
from aec_tpu_torch.kernels.lstm_costs import registers
from aec_tpu_torch.kernels.serving_costs import call_ms

VARIANTS = {"full": [], "no_constraint_fft": ["-DAEC_NO_CONSTRAINT_FFT"],
            "no_echo_fft": ["-DAEC_NO_ECHO_FFT"], "clocks": []}
N = 131072  # one 8.2 s utterance at 16 kHz: 512 blocks of 256
# the default instantiations' mangled names: <kNlms, FixedGeom<256, 10, 32>, FixedPlan<8, 8, 4>>
DEFAULT = ("single_fft_kernel", "FixedGeomILi256ELi10ELi32E", "FixedPlanIJLi8ELi8ELi4E")
# the phases the clocked build marks, in the order of a step
PHASES = ("estimate", "barrier A", "echo transforms", "barrier B", "gain", "barrier C", "jobs",
          "stores", "barrier D")
# (text in single_stream.cu, what the clocked build puts in its place): a
# mark adds the cycles since the last one to its phase
_MARKS = (
    ("  const float inv_n = 1.f / F;\n",
     "  const float inv_n = 1.f / F;\n"
     "  long long ck[9] = {0}, c0 = clock64();\n"
     "  const bool rec = tid == 0 || tid == 32;\n"
     "#define MARK(i) if (rec) { const long long c_ = clock64(); ck[i] += c_ - c0; c0 = c_; }\n"),
    ("      if (lane == 0) s.red[warp] = sum;\n    }\n    __syncthreads();\n",
     "      if (lane == 0) s.red[warp] = sum;\n    }\n    MARK(0) __syncthreads(); MARK(1)\n"),
    ("#endif\n    }\n    __syncthreads();\n\n    // 3. all threads",
     "#endif\n    }\n    MARK(2) __syncthreads(); MARK(3)\n\n    // 3. all threads"),
    ("      }\n    }\n    __syncthreads();\n\n    // 4. jobs",
     "      }\n    }\n    MARK(4) __syncthreads(); MARK(5)\n\n    // 4. jobs"),
    ("    if (tid < B) {\n      far_of(t + 2)[tid] = fx;",
     "    MARK(6) if (tid < B) {\n      far_of(t + 2)[tid] = fx;"),
    ("    if (t + 1 < t_blocks) fetch(t + 1);\n    __syncthreads();\n  }\n}\n",
     "    if (t + 1 < t_blocks) fetch(t + 1);\n    MARK(7) __syncthreads(); MARK(8)\n  }\n"
     "  if (rec) for (int i = 0; i < 9; ++i) aec_clocks[tid / 32][i] = ck[i];\n}\n"),
    ("template <bool kNlms, class G, class Plan>\n__global__",
     "__device__ long long aec_clocks[2][9];\n\ntemplate <bool kNlms, class G, class Plan>\n"
     "__global__"),
)


def clocked(text: str) -> str:
    """single_stream.cu with the phase marks (:data:`_MARKS`) and an entry
    ``aec_read_clocks`` that copies out warps 0 and 1's cycles per phase,
    summed over the steps of the last launch."""
    for old, new in _MARKS:
        if text.count(old) != 1:
            raise ValueError(f"single_stream.cu no longer has one {old!r}: update _MARKS")
        text = text.replace(old, new)
    return text + ('\nextern "C" int aec_read_clocks(long long* h) {\n'
                   "  return cudaMemcpyFromSymbol(h, aec_clocks, sizeof(aec_clocks));\n}\n")


def start_build() -> dict:
    """Start compiling every variant, one ``nvcc`` each, all at once;
    :func:`finish_build` waits for them."""
    procs = {}
    for variant, defines in VARIANTS.items():
        d = _build.BUILD / "single_costs" / variant
        d.mkdir(parents=True, exist_ok=True)
        src = _build.CSRC / "single_stream.cu"
        if variant == "clocks":
            src = d / "single_stream.cu"
            src.write_text(clocked((_build.CSRC / "single_stream.cu").read_text()))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
               str(d / "lib.so"), str(src)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), d / "lib.so")
    return procs


def finish_build(procs: dict) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (bound library, nvcc's log)} of :func:`start_build`'s compiles."""
    libs = {}
    for variant, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for single_stream ({variant}):\n{log}")
        libs[variant] = (bind_single(ctypes.CDLL(str(out))), log)
    return libs


def costs(libs, reps: int, seed: int = 0) -> list[dict]:
    """K6 and K7 on one 8.2 s utterance, whole and cut, and their phases."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    far = torch.randn(N, generator=g, device=dev)
    mic = 0.5 * far + 0.01 * torch.randn(N, generator=g, device=dev)
    mhz = torch.cuda.get_device_properties(dev).clock_rate / 1e3
    log, steps = libs["full"][1], N // 256
    out = []
    for name, cfg, nlms in (("K6", KalmanConfig(), "ILb0E"), ("K7", NlmsConfig(), "ILb1E")):
        row = {"kernel": name, "shape": f"L = {cfg.n_blocks}, block 256, {steps} blocks",
               "registers": registers(log, DEFAULT[0] + nlms, *DEFAULT[1:]), "ms": {}}
        for variant, (lib, _) in libs.items():
            if variant != "clocks":
                row["ms"][variant] = call_ms(lambda: launch_single(cfg, far, mic, 256, lib), reps)
        row["us_per_step"] = {v: ms / steps * 1e3 for v, ms in row["ms"].items()}
        lib = libs["clocks"][0]
        launch_single(cfg, far, mic, 256, lib)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (2 * len(PHASES)))()
        _build.check(lib.aec_read_clocks(buf), "single_costs clocks")
        row["cycles"] = {f"warp {w}": {p: buf[w * len(PHASES) + i] / steps
                                       for i, p in enumerate(PHASES)} for w in (0, 1)}
        row["mhz"] = mhz
        out.append(row)
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    steps = ", ".join(f"{v} {ms:.3f} ms = {row['us_per_step'][v]:.2f} us" for v, ms in
                      row["ms"].items())
    phases = "; ".join(f"{w}: " + ", ".join(f"{p} {c:.0f}" for p, c in cyc.items())
                       for w, cyc in row["cycles"].items())
    total = sum(row["cycles"]["warp 0"].values())
    return (f"{row['kernel']} {row['shape']}: a call and a step, whole and cut: {steps}; cycles "
            f"a step by phase ({phases}; warp 0's sum {total:.0f} = {total / row['mhz']:.2f} us "
            f"at {row['mhz']:.0f} MHz, marks included); ptxas {row['registers']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("single_costs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = finish_build(start_build())
    with torch.no_grad():
        for row in costs(libs, args.reps):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
