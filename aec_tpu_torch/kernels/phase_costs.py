"""Where K2's phases spend their time, on the card.

    python -m aec_tpu_torch.kernels.phase_costs [--batch 256] [--blocks 512]

Builds variants of ``csrc/stage2.cu`` with one part of a phase cut out
(into ``_build/phase_costs/``), runs each through
:func:`kernels.stage2.launch_phases` on one input (the robust checkpoint,
a residual echo over a near-end floor) and prints each kernel's device time
from ``torch.profiler``, beside the card's name and power limit. A variant's
outputs are meaningless; only its times are read. The difference between
the full kernel and a variant is the cost of the part cut out:

- ``A_no_fft``: phase A without its forward FFTs;
- ``A_no_projections``: phase A without the ERB and GRU input projections;
- ``C_no_forward``: phase C without the forward FFT that recomputes the lin
  spectrum, the work a phase C reading stored spectra would skip;
- ``C_no_fft``: phase C without its forward and inverse FFTs.

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from aec_tpu_torch.kernels import _build, stage2

_A_FWD = ("  const SArr z = tr.forward(q, L, FrameAt{lin + sig, far + sig, f0, n, B, t_blocks * B}, "
          "s.a, s.b,\n                            s.tw, s.win);\n")
_C_FWD = ("  const SArr z = tr.forward(q, n, FrameAt{lin + sig, lin + sig, g0, n, B, t_blocks * B}, "
          "s.a, s.b,\n                            s.tw, s.win);\n")
_C_INV = "  const SArr zs = tr.inverse(q, n, y, z, s.tw);"


def _cut(text: str, start: str, end: str, keep: str = "") -> str:
    i = text.index(start)
    return text[:i] + keep + text[text.index(end, i):]


def variants(text: str) -> dict[str, str]:
    """The stage2.cu sources to time, by name."""
    same = "  const SArr z = s.a;\n"
    return {
        "full": text,
        "A_no_fft": text.replace(_A_FWD, same),
        "A_no_projections": _cut(text, "  // ERB projections me",
                                 "// ---------------------------------------------------------------- C.",
                                 "}\n\n"),
        "C_no_forward": text.replace(_C_FWD, same),
        "C_no_fft": text.replace(_C_FWD, same).replace(_C_INV, "  const SArr zs = z;"),
    }


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile every variant with the kernels' flags, in parallel."""
    root = _build.BUILD / "phase_costs"
    procs = {}
    for name, text in sources.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "stage2.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / "stage2.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for fn in ("aec_stage2_analyse", "aec_stage2_synthesise", "aec_stage2_smem"):
            ref = getattr(stage2._lib(), fn)
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = ref.argtypes, ref.restype
        libs[name] = lib
    return libs


def kernel_us(fn, reps: int) -> dict[str, float]:
    """Device µs per call of each CUDA kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]: e.device_time_total / reps
            for e in prof.key_averages() if e.device_time_total > 0 and "kernel" in e.key}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_costs: needs a CUDA device")
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.utils.weights import load_npz

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    net = load_npz("checkpoints/little_net_robust.npz", device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    far = torch.randn(args.batch, args.blocks, 256, generator=g, device=dev)
    lin = 0.3 * far + 0.05 * torch.randn(args.batch, args.blocks, 256, generator=g, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    run = stage2.frames_per_cta(args.batch, args.blocks + 1, sms)
    libs = build(variants((_build.CSRC / "stage2.cu").read_text()))
    with torch.no_grad():
        for name, lib in libs.items():
            us = kernel_us(lambda: stage2.launch_phases(lib, net, lin, far, erb, StftConfig(),
                                                        False, run), args.reps)
            print(f"{name:17s} B = {args.batch} x {args.blocks} blocks, runs of {run}: "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in sorted(us.items())) + f" [{smi}]",
                  flush=True)


if __name__ == "__main__":
    main()
