"""Realtime serving loop on the serving kernel K3, the port's
``examples/serving_loop.py``.

1. ``serving_init`` allocates the state of S sessions on the card;
2. each arriving 16 ms block batch is ONE ``serving_step_fused`` call (K3),
   which updates the state tensors in place (JAX donates them), ending in a
   host readback of the block: the block's latency;
3. ``serving_erle`` reads the kernel's per-session monitor of mic and
   stage-1 residual power, the live ERLE.

  python -m aec_tpu_torch.examples.serving_loop [--streams 128] [--blocks 50] [--device cpu]

JAX's ``--tile`` (a TPU lane tile) and ``--interpret`` (Pallas interpret
mode for the CPU) become ``--device``, as in the port's CLIs: on the CPU
the step is K3's plain version, every product in plain fp32 (JAX's
``dot_mode="high"`` grade). The net is ``checkpoints/little_net_general.npz``
where it exists, else a random net (``torch.Generator`` seed 0).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.kernels.serving import serving_erle, serving_init, serving_step_fused
from aec_tpu_torch.models.little_net import little_net_init
from aec_tpu_torch.utils.weights import load_npz

HOP = 256
CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "..", "checkpoints",
                          "little_net_general.npz")


def make_sessions(streams: int, blocks: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(far, mic) float32 (S, blocks * HOP): synthetic echo sessions, each
    its own random 256-tap RIR (JAX's draws from ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    n = blocks * HOP
    far = rng.standard_normal((streams, n)).astype(np.float32) * 0.3
    rirs = (np.exp(-np.arange(256) / 48.0)[None]
            * rng.standard_normal((streams, 256))).astype(np.float32) * 0.5
    mic = np.stack([np.convolve(far[i], rirs[i])[:n] for i in range(streams)]).astype(np.float32)
    return far, mic


def load_net(device):
    """The general checkpoint's LittleNet on ``device``, else a random one."""
    if os.path.isfile(CHECKPOINT):
        return load_npz(CHECKPOINT, device=device)
    return little_net_init(generator=torch.Generator().manual_seed(0), device=device)


def serve(net, far: np.ndarray, mic: np.ndarray, device, step=serving_step_fused):
    """Every block of every session through ``step`` (K3 on the card), one
    call a block, each ending in its output's readback -> (out (S, n) with
    the one-hop lag undone, the blocks' latencies in s, the final state)."""
    erb = torch.as_tensor(erb_filterbank(), device=device)
    state = serving_init(far.shape[0], device=device)
    out = np.zeros_like(mic)
    lat = []
    for t in range(far.shape[-1] // HOP):
        blk = slice(t * HOP, (t + 1) * HOP)
        fb = torch.as_tensor(far[:, blk], device=device)
        mb = torch.as_tensor(mic[:, blk], device=device)
        t0 = time.perf_counter()
        state, o = step(net, state, fb, mb, erb)
        o = o.cpu().numpy()  # host readback == block completion
        lat.append(time.perf_counter() - t0)
        if t:  # one-hop output lag; the t = 0 emission is the trimmed edge
            out[:, (t - 1) * HOP : t * HOP] = o
    return out, lat, state


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--streams", type=int, default=128)
    p.add_argument("--blocks", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    far, mic = make_sessions(args.streams, args.blocks)
    out, lat, state = serve(load_net(dev), far, mic, dev)
    half = mic.shape[-1] // 2
    erle = 10 * np.log10((mic[:, half:] ** 2).mean() / max((out[:, half:] ** 2).mean(), 1e-12))
    live = serving_erle(state).cpu().numpy()
    print(f"live monitor ERLE (dB): min {live.min():.1f} / "
          f"median {np.median(live):.1f} / max {live.max():.1f}")
    lat_ms = np.asarray(lat[1:]) * 1e3  # drop the first call (the kernel's build)
    print(f"{args.streams} sessions x {args.blocks} blocks: tail ERLE {erle:.1f} dB | "
          f"block latency p50 {np.percentile(lat_ms, 50):.2f} ms / "
          f"p99 {np.percentile(lat_ms, 99):.2f} ms (16 ms realtime budget)")


if __name__ == "__main__":
    main()
