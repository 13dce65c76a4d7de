"""How a K3 call's time splits between the host and the card.

    python -m aec_tpu_torch.kernels.serving_costs [--streams 8 1024] [--reps 20]

For each stage-1 filter and stream count: one-hop calls of
``serving_step_fused`` on noise through the robust checkpoint. A call's
time is CUDA events around one call with the card idle before it (median
of ``--reps``); the kernel's time is its device time from
``torch.profiler`` over as many calls, each followed by a synchronize. The
host's share is 1 - kernel / call. It reads only ``serving_init``,
``serving_step_fused``, the checkpoint and the ERB matrix, so it measures
any tree of the port put first on ``PYTHONPATH`` (a parent commit
included). Needs the card; a measurement tool, not part of any route.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch


def kernel_ms(fn, reps: int, name: str) -> float:
    """Device ms per call of the CUDA kernels whose name contains ``name``,
    over ``reps`` calls of ``fn``, each followed by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if name in e.key) / reps / 1e3


def call_ms(fn, reps: int) -> float:
    """Median ms of one call between two CUDA events, the card idle before
    it (after a warm-up call); ``chip_smoke.py`` times its calls with it."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def costs(net, erb, streams: int, stage1: str, reps: int, seed: int = 0) -> dict:
    """{"call_ms", "kernel_ms", "host_share"} of one-hop K3 calls for
    ``streams`` streams."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused

    dev = erb.device
    g = torch.Generator(device=dev).manual_seed(seed)
    far = torch.randn(streams, 256, generator=g, device=dev)
    mic = 0.5 * far + 0.01 * torch.randn(streams, 256, generator=g, device=dev)
    st = serving_init(streams, stage1=stage1, device=dev)

    def step():
        serving_step_fused(net, st, far, mic, erb, stage1=stage1)

    with torch.no_grad():
        c, k = call_ms(step, reps), kernel_ms(step, reps, "serving_kernel")
    return {"call_ms": c, "kernel_ms": k, "host_share": 1.0 - k / c}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[8, 1024])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serving_costs: needs a CUDA device")
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.utils.weights import load_npz

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    net = load_npz("checkpoints/little_net_robust.npz", device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    for stage1 in ("kalman", "nlms"):
        for s in args.streams:
            print(json.dumps({"stage1": stage1, "streams": s, **costs(net, erb, s, stage1,
                                                                      args.reps),
                              "card": smi}), flush=True)


if __name__ == "__main__":
    main()
