"""Where the steps of K8's and K8b's wide path spend their time, on the card,
and the DCT-CNN's train step of two trees of the port in turns.

    python -m aec_tpu_torch.kernels.gru_wide_costs [--reps 5]
    python aec_tpu_torch/kernels/gru_wide_costs.py --ab OTHER_TREE [--reps 3]

The first builds ``csrc/gru_wide.cu`` into ``_build/gru_wide_costs/`` as it
is and without its dots (``-DAEC_NO_DOTS``: a step's exchange, its waits and
the cells) and runs K8 and K8b at the wide path's shapes (B = 1, T = 1001 at
H = 129 and 512; the DCT-CNN's training batch, 16 x 501 at H = 512, K8
saving the gates there): ms (CUDA events, the median of ``--reps`` calls, the
card idle before each), µs a step, whole and cut, and ptxas's registers and
spills of the instantiation that ran, beside the card's name and power
limit. A cut variant's outputs are meaningless; only its time is read.
``chip_smoke.py`` prints the same through :func:`start_build`,
:func:`finish_build` and :func:`costs`.

The second times the DCT-CNN's ``make_stateful_train_step`` at
``TrainConfig()``'s batch (16 scenes x 8 s of ``benchmarks.scenes``, seeds
0 and 1) as ``chip_smoke.py`` phase 26 runs it, in this tree and in
OTHER_TREE (a checkout of another commit, its own package imported), each
in a process of its own, in turns (other, this, this, other): the median of
``--reps`` steps after a first one (host clock, each ending in the loss's
readback), with K8's and K8b's launches a step. It reads only names both
trees have.

Needs the card and ``nvcc``; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

VARIANTS = {"full": [], "no_dots": ["-DAEC_NO_DOTS"]}
# (B, T, H, save): validation and inference at B = 1, the DCT-CNN's train step
SHAPES = ((1, 1001, 129, False), (1, 1001, 512, False), (16, 501, 512, True))


def start_build() -> dict:
    """Start compiling ``gru_wide.cu`` in both variants, one ``nvcc`` each;
    :func:`finish_build` waits for them."""
    from aec_tpu_torch.kernels import _build

    procs = {}
    for variant, defines in VARIANTS.items():
        out = _build.BUILD / "gru_wide_costs" / variant / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
               str(out), str(_build.CSRC / "gru_wide.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_build(procs: dict) -> dict:
    """{variant: (bound library, nvcc's log)} of :func:`start_build`'s
    compiles."""
    import ctypes

    from aec_tpu_torch.kernels.gru import bind_wide

    libs = {}
    for variant, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for gru_wide ({variant}):\n{log}")
        libs[variant] = (bind_wide(ctypes.CDLL(str(out))), log)
    return libs


def costs(libs: dict, reps: int, seed: int = 0) -> list[dict]:
    """K8 and K8b at each of :data:`SHAPES`, whole and cut."""
    from aec_tpu_torch.kernels import _build, gru
    from aec_tpu_torch.kernels.lstm_costs import registers
    from aec_tpu_torch.kernels.serving_costs import call_ms

    dev = torch.device("cuda", 0)
    out = []
    for b, t, h, save in SHAPES:
        g = torch.Generator().manual_seed(seed + h)
        w = ((torch.rand(3 * h, h, generator=g) * 2 - 1) / h ** 0.5).to(dev)
        xp = torch.randn(b, t, 3 * h, generator=g).to(dev)
        b_hn, h0 = torch.zeros(h, device=dev), torch.zeros(b, h, device=dev)
        ys, gates = xp.new_empty((b, t, h)), xp.new_empty((b, t, 4 * h))
        g_ys = torch.randn(b, t, h, generator=g).to(dev)
        dxp, dhn, dh0 = xp.new_empty((b, t, 3 * h)), torch.empty_like(ys), torch.empty_like(h0)
        fwd, bwd = gru.wide_plan(b, h, False), gru.wide_plan(b, h, True)
        _build.check(gru.wide_forward(libs["full"][0], fwd, xp, w, b_hn, h0, ys, gates), "gru")
        torch.cuda.synchronize()
        rt = 1 if b == 1 else 8
        runs = {"K8": (fwd, 1 if save else 0, lambda lib: gru.wide_forward(
                    lib, fwd, xp, w, b_hn, h0, ys, gates if save else None)),
                "K8b": (bwd, 2, lambda lib: gru.wide_backward(
                    lib, bwd, g_ys, gates, ys, h0, w, dxp, dhn, dh0))}
        for kernel, (plan, mode, launch) in runs.items():
            row = {"kernel": kernel, "shape": f"B = {b}, T = {t}, H = {h}"
                   + (", saving the gates" if kernel == "K8" and save else ""),
                   "ctas": plan.nchunk, "exchange": "words" if plan.tagged else "counter",
                   "registers": registers(libs["full"][1],
                                          f"gru_wide_kernelILi{plan.cw}ELi{rt}ELi{mode}E"),
                   "ms": {}}
            for variant, (lib, _) in libs.items():
                row["ms"][variant] = call_ms(lambda: _build.check(launch(lib), kernel), reps)
            row["us_per_step"] = {v: ms / t * 1e3 for v, ms in row["ms"].items()}
            out.append(row)
        del w, xp, ys, gates, g_ys, dxp, dhn
    return out


def report(row: dict) -> str:
    """One line of :func:`costs`' row."""
    steps = ", ".join(f"{v} {ms:.4f} ms = {row['us_per_step'][v]:.3f} us" for v, ms in
                      row["ms"].items())
    return (f"{row['kernel']} (wide) {row['shape']}: a call and a step, whole and cut: {steps}; "
            f"{row['ctas']} CTAs, h exchanged by {row['exchange']}; ptxas {row['registers']}")


def dct_cnn_step(reps: int) -> dict:
    """The DCT-CNN's train step at ``TrainConfig()`` in whichever tree's
    package is on the path: {"step_ms": [...], "k8": K8 launches a step,
    "k8b": K8b launches a step}."""
    import numpy as np

    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.models.dct_net import DctCnn
    from aec_tpu_torch.models.registry import get_model
    from aec_tpu_torch.train.loop import make_optimizer, make_stateful_train_step
    from benchmarks.scenes import make_scenes

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as chip_smoke.py's phase 26 times it
    dev = torch.device("cuda", 0)
    cfg = TrainConfig()
    scenes = [sc for sd in (0, 1)
              for sc in make_scenes(np.random.default_rng(sd), n=128000).values()]
    far, mic, near = (torch.from_numpy(np.stack([sc[i] for sc in scenes])).to(dev)
                      for i in range(3))
    batch = (mic, far, near, mic - near)
    spec = get_model("dct_cnn")
    net = DctCnn(spec.init(generator=torch.Generator().manual_seed(0), device=dev))
    step = make_stateful_train_step(
        lambda p, s, m, f, ne, e: (spec.loss(p, m, ne)[0], {"state": s}),
        make_optimizer(cfg, 1, net))
    float(step({}, *batch)[1])
    before = gru_recurrence.launches, gru_backward.launches
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(step({}, *batch)[1])
        times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": times, "k8": (gru_recurrence.launches - before[0]) / reps,
            "k8b": (gru_backward.launches - before[1]) / reps}


def ab(other: str, reps: int) -> list[tuple[str, dict]]:
    """:func:`dct_cnn_step` of OTHER_TREE and of this tree in turns (other,
    this, this, other), each in a process of its own."""
    here, other = str(Path(__file__).resolve().parents[2]), str(Path(other).resolve())
    out = []
    for tree in (other, here, here, other):
        env = {**os.environ, "PYTHONPATH": tree}
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--step",
                              "--reps", str(reps)], cwd=tree, env=env, capture_output=True,
                             text=True)
        if run.returncode:
            raise RuntimeError(f"the step in {tree} failed:\n{run.stdout}\n{run.stderr}")
        out.append(("this" if tree == here else "other", json.loads(run.stdout.splitlines()[-1])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ab", metavar="OTHER_TREE", help="the DCT-CNN step here and there, in turns")
    ap.add_argument("--step", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gru_wide_costs: needs a CUDA device")
    if args.step:  # the other tree's package, not this file's neighbours
        here = Path(__file__).resolve().parent
        sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
        print(json.dumps(dct_cnn_step(args.reps)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.ab:
        for tree, row in ab(args.ab, args.reps):
            steps = ", ".join(f"{v:.2f}" for v in row["step_ms"])
            print(f"DCT-CNN step, 16 x 8 s ({tree} tree): {steps} ms, median "
                  f"{statistics.median(row['step_ms']):.2f}; K8 / K8b launches a step "
                  f"{row['k8']:g} / {row['k8b']:g} [{smi}]", flush=True)
        return
    libs = finish_build(start_build())
    with torch.no_grad():
        for row in costs(libs, args.reps):
            print(f"{report(row)} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
