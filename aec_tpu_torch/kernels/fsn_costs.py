"""Where K11's time goes, on the card: the producer alone and the consumers alone.

    python -m aec_tpu_torch.kernels.fsn_costs [--reps 5]

Builds ``csrc/fullsubnet.cu`` into ``_build/fsn_costs/`` as it is and cut
(:data:`VARIANTS`): with the consumers returning at once
(``-DAEC_PRODUCER_ONLY``: the full-band chain and the embedding words, as a
launch of its own would run them), and with the producer returning at once
(``-DAEC_CONSUMERS_ONLY``: the sub-band rows, which then read the zeroed
embedding words without waiting for a step). Runs each at
FullSubNetConfig()'s widths (H_fb 256, H_sb 96, F = 161) over one 8.2 s
utterance's 820 frames at B = 1 and 4 and prints its ms (CUDA events, the
median of ``--reps`` calls, the card idle before each), its µs a frame and
ptxas's registers and spills for the instantiation that ran, beside the
card's name and power limit. The sum of the two parts against the whole
says how far they overlap. A cut variant's outputs are meaningless; only
its time is read. ``chip_smoke.py`` prints the same through
:func:`start_build`, :func:`finish_build` and :func:`costs`.

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels import fullsubnet as k11
from aec_tpu_torch.kernels.lstm_costs import registers
from aec_tpu_torch.kernels.serving_costs import call_ms

VARIANTS = {"full": [], "producer": ["-DAEC_PRODUCER_ONLY"],
            "consumers": ["-DAEC_CONSUMERS_ONLY"]}
T_FRAMES = 820  # one 8.2 s utterance at FullSubNet's hop of 160
BATCHES = (1, 4)


def start_build() -> dict:
    """Start compiling every variant, one ``nvcc`` each, all at once;
    :func:`finish_build` waits for them."""
    procs = {}
    for variant, defines in VARIANTS.items():
        out = _build.BUILD / "fsn_costs" / variant / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
               str(out), str(_build.CSRC / "fullsubnet.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (bound library, nvcc's log)} of :func:`start_build`'s compiles."""
    libs = {}
    for variant, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for fullsubnet ({variant}):\n{log}")
        libs[variant] = (k11.bind(ctypes.CDLL(str(out))), log)
    return libs


def case(dev, b: int, seed: int = 0):
    """FullSubNetConfig()'s weights and random projections at B utterances."""
    from aec_tpu_torch.models.fullsubnet import FullSubNetConfig, fullsubnet_init

    cfg = FullSubNetConfig()
    g = torch.Generator().manual_seed(seed)
    params = fullsubnet_init(cfg, generator=g, device=dev)
    xp_fb = (0.3 * torch.randn(b, T_FRAMES, 4 * cfg.fb_hidden, generator=g)).to(dev)
    xp_sb = (0.3 * torch.randn(b, T_FRAMES, cfg.n_freqs, 4 * cfg.sb_hidden,
                               generator=g)).to(dev)
    return params, xp_fb, xp_sb


def costs(libs, reps: int, seed: int = 0) -> list[dict]:
    """K11 at B = 1 and 4, whole and cut."""
    dev = torch.device("cuda", 0)
    log = libs["full"][1]
    out = []
    for b in BATCHES:
        params, xp_fb, xp_sb = case(dev, b, seed)
        weights = [params[x][y] for x, y in k11._LEAVES]
        plan = k11.card_plan(b, xp_sb.shape[2], xp_fb.shape[2] // 4, xp_sb.shape[3] // 4, dev)
        kernel = f"fsn_kernelILi{k11.pass_rows(b)}ELi{k11.pass_rows(plan['rows'])}E"
        row = {"kernel": "K11", "b": b, "shape": f"B = {b}, T = {T_FRAMES}, H_fb 256, H_sb 96",
               "plan": plan, "registers": registers(log, kernel), "ms": {}}
        for variant, (lib, _) in libs.items():
            row["ms"][variant] = call_ms(lambda: k11.launch(weights, xp_fb, xp_sb, lib), reps)
        row["us_per_frame"] = {v: ms / T_FRAMES * 1e3 for v, ms in row["ms"].items()}
        out.append(row)
        del params, xp_fb, xp_sb
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    parts = ", ".join(f"{v} {ms:.3f} ms = {row['us_per_frame'][v]:.2f} us" for v, ms in
                      row["ms"].items())
    plan = row["plan"]
    return (f"{row['kernel']} {row['shape']}: whole and cut, a call and a frame: {parts} "
            f"(parts' sum {row['ms']['producer'] + row['ms']['consumers']:.3f} ms); "
            f"{plan['clusters']} clusters, {plan['consumers']} consumer CTAs of <= "
            f"{plan['rows']} rows; ptxas {row['registers']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fsn_costs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = finish_build(start_build())
    with torch.no_grad():
        for row in costs(libs, args.reps):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
