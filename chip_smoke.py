"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Runs ``aec_tpu_torch`` (never JAX): builds the CUDA kernels from the sources
in the checkout, holds each kernel against its plain PyTorch version at the
main path's full shape (batch 256 x 131,072 samples = 8.2 s at 16 kHz,
Kalman L=10 / block 256 / K=257, the width-1 LittleNet of
``checkpoints/little_net_robust.npz``), drives ``two_stage_cancel`` on the 8
scenes of ``benchmarks/scenes.py`` and grades them against the plain (CPU)
route, then times kernels, plain versions and the whole pipeline with CUDA
events. One line per phase; the first failure exits nonzero (nothing is
caught). The second-to-last line is the ``kernels`` JSON, the last line
the ``ok`` JSON. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, N = 256, 131072  # the main path's shape: 256 utterances x 8.2 s
SR = 16000
# K1 vs plain: both fp32, other summation orders, round-off carried through
# 512 recursive block updates -> a bar of 1e-3 of the signal scale
K1_TOL = 1e-3
# K2 vs plain on the same input: fp32 round-off through DFT, GRU and pinv
# synthesis, no recursion beyond the 32-wide GRU -> 1e-4 of scale, mask 1e-5
K2_WAV_TOL, K2_MASK_TOL = 1e-4, 1e-5
ERLE_TOL_DB = 0.1  # kernel route vs plain route, tail ERLE per scene


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` runs of one call, CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_batch(dev, seed: int):
    """Far-end noise through a random decaying 512-tap echo path per
    utterance, plus a low near-end noise floor; made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    far = torch.randn(BATCH, N, generator=g, device=dev)
    rir = torch.randn(BATCH, 512, generator=g, device=dev)
    rir = rir * torch.exp(-torch.arange(512, device=dev) / 100.0)
    rir = 0.5 * rir / rir.abs().amax(-1, keepdim=True)
    nfft = N + 512
    echo = torch.fft.irfft(torch.fft.rfft(far, nfft) * torch.fft.rfft(rir, nfft), nfft)[:, :N]
    mic = echo + 0.01 * torch.randn(BATCH, N, generator=g, device=dev)
    return far.contiguous(), mic.contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels import _build
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.kernels.stage2 import (
        little_net_apply_fused,
        little_net_apply_fused_plain,
    )
    from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
    from aec_tpu_torch.utils.weights import load_npz
    from benchmarks.scenes import erle_tail, make_scenes

    # plain versions compute in full fp32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. the card and its power limit, as nvidia-smi gives them
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 3. build both kernels from the checkout's sources (in parallel)
    t0 = time.perf_counter()
    logs = _build.build("kalman_batched", "stage2")
    build_s = time.perf_counter() - t0
    phase("build", f"{build_s:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                phase("build", f"{src}: {line.strip()}")

    cfg = KalmanConfig()
    net = load_npz("checkpoints/little_net_robust.npz").to(dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)

    # 4. each kernel vs its plain version at the main path's full shape
    far, mic = make_batch(dev, args.seed)
    with torch.no_grad():
        e_k = kalman_cancel_fused_batched(cfg, far, mic)["wav"]
        e_p = kalman_cancel_plain(cfg, far, mic)["wav"]
        torch.cuda.synchronize()
        mic_scale = float(mic.abs().max())
        k1_err = float((e_k - e_p).abs().max())
        check(e_k.shape == mic.shape and bool(torch.isfinite(e_k).all()), "K1 output")
        phase("K1 vs plain", f"max|d| = {k1_err:.3e}, bar {K1_TOL:g} x max|mic| = "
              f"{K1_TOL * mic_scale:.3e}")
        check(k1_err <= K1_TOL * mic_scale, "K1 disagrees with its plain version")

        lin_b, far_b = e_p.reshape(BATCH, -1, 256), far.reshape(BATCH, -1, 256)
        o_k, m_k = little_net_apply_fused(net, lin_b, far_b, erb)
        o_p, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb)
        torch.cuda.synchronize()
        wav_scale = float(o_p.abs().max())
        k2_err = float((o_k - o_p).abs().max())
        k2_mask_err = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(o_k).all()) and m_k.shape == (BATCH, N // 256 + 1, 32),
              "K2 output")
        phase("K2 vs plain", f"wav max|d| = {k2_err:.3e} (bar {K2_WAV_TOL * wav_scale:.3e}), "
              f"mask max|d| = {k2_mask_err:.3e} (bar {K2_MASK_TOL:g})")
        check(k2_err <= K2_WAV_TOL * wav_scale, "K2 wav disagrees with its plain version")
        check(k2_mask_err <= K2_MASK_TOL, "K2 mask disagrees with its plain version")
    del e_k, e_p, o_k, o_p, m_k, m_p

    # 5. the main path end to end on the 8 scenes, kernel route vs plain route
    scenes = make_scenes(np.random.default_rng(args.seed), n=N)
    names = list(scenes)
    s_far = np.stack([scenes[k][0] for k in names])
    s_mic = np.stack([scenes[k][1] for k in names])
    kernels = (kalman_cancel_fused_batched, little_net_apply_fused)
    for k in kernels:
        k.launches = 0
    out = two_stage_cancel(
        net, torch.from_numpy(s_far).to(dev), torch.from_numpy(s_mic).to(dev), erb
    )
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    phase("main path", f"two_stage_cancel 8 x {N}: launches K1 {launches[0]}, K2 {launches[1]}")
    check(all(n > 0 for n in launches), "the main path did not go through every kernel")
    out = {k: v.cpu().numpy() for k, v in out.items()}
    check(out["wav"].shape == s_mic.shape and np.isfinite(out["wav"]).all(), "two_stage output")
    ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz"),
                           torch.from_numpy(s_far), torch.from_numpy(s_mic), erb_filterbank())
    with open("benchmarks/results/checkpoint_quality_r3.json") as f:
        jax_grades = json.load(f)["robust"]
    phase("scenes", "tail ERLE dB: stage1 kernel/plain, two-stage kernel/plain | JAX grade "
          "(robust, 4.1 s scenes, TPU v5e; information only)")
    worst = 0.0
    for i, k in enumerate(names):
        s1 = (erle_tail(s_mic[i], out["linear_wav"][i]),
              erle_tail(s_mic[i], ref["linear_wav"][i].numpy()))
        s2 = erle_tail(s_mic[i], out["wav"][i]), erle_tail(s_mic[i], ref["wav"][i].numpy())
        worst = max(worst, abs(s1[0] - s1[1]), abs(s2[0] - s2[1]))
        jg = jax_grades.get(k, {})
        phase("scenes", f"{k:13s} {s1[0]:8.3f} {s1[1]:8.3f} | {s2[0]:8.3f} {s2[1]:8.3f} | "
              f"JAX {jg.get('stage1_erle_db')} / {jg.get('two_stage_erle_db')}")
    phase("scenes", f"worst |kernel - plain| = {worst:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(worst <= ERLE_TOL_DB, "kernel route and plain route disagree in tail ERLE")

    # 6. times at the main path's shape (median of --reps, CUDA events)
    with torch.no_grad():
        t_k1 = time_ms(lambda: kalman_cancel_fused_batched(cfg, far, mic), args.reps)
        t_p1 = time_ms(lambda: kalman_cancel_plain(cfg, far, mic), args.reps)
        t_k2 = time_ms(lambda: little_net_apply_fused(net, lin_b, far_b, erb), args.reps)
        t_p2 = time_ms(lambda: little_net_apply_fused_plain(net, lin_b, far_b, erb), args.reps)
        t_all = time_ms(lambda: two_stage_cancel(net, far, mic, erb), args.reps)
    xrt = BATCH * N / SR / (t_all / 1e3)
    phase("time", f"K1 {t_k1:.2f} ms (plain {t_p1:.2f} ms); K2 {t_k2:.2f} ms (plain {t_p2:.2f} ms)")
    phase("time", f"two_stage_cancel {BATCH} x {N}: {t_all:.2f} ms = {xrt:.1f} x realtime "
          f"[{smi}]")
    print(f"two_stage_ms={t_all:.3f} xrt={xrt:.1f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)

    # 7. the kernels of the path, with this run's numbers
    print(json.dumps({"kernels": [
        {"name": "kalman_batched", "route": "cuda",
         "source": "aec_tpu_torch/kernels/csrc/kalman_batched.cu",
         "replaces": "aec_tpu/kernels/pallas_kalman.py:492", "launches": launches[0],
         "max_abs_err": k1_err, "ms": t_k1, "plain_ms": t_p1},
        {"name": "stage2", "route": "cuda", "source": "aec_tpu_torch/kernels/csrc/stage2.cu",
         "replaces": "aec_tpu/kernels/pallas_stage2.py:100", "launches": launches[1],
         "max_abs_err": k2_err, "ms": t_k2, "plain_ms": t_p2},
    ]}), flush=True)
    # 8. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
