"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Runs ``aec_tpu_torch`` (never JAX): builds the six CUDA sources in the
checkout (seven kernels), in parallel, and drives every user-facing path.

- Offline Kalman (phases 4, 5, 7): each kernel against its plain PyTorch
  version at the main path's full shape (batch 256 x 131,072 samples =
  8.2 s at 16 kHz, L=10 / block 256 / K=257, the width-1 LittleNet of
  ``checkpoints/little_net_robust.npz``); ``two_stage_cancel`` on the 8
  scenes of ``benchmarks/scenes.py``, graded against the plain (CPU) route;
  the ``quality="fast"`` route, which runs the whole pipeline as K4.
- Streaming serving (phases 8, 9): K3 against its plain version at
  S = 1024 live streams (bench config ``concurrent_streams``), then the 8
  scenes streamed hop by hop through K3 against the offline result.
- NLMS and single utterances (phases 11-14): K5 (batched NLMS) at the main
  shape, K6 / K7 (single-stream Kalman / NLMS on one thread-block cluster)
  on one 16 s utterance (bench configs #1 and #2) and a hop-fractional one,
  twice with other inputs; the 8 scenes with ``stage1="nlms"`` through the
  batched (K5 + K2), single-stream (K7 + K2) and serving (K3-NLMS) routes,
  and through the single-stream Kalman route (K6 + K2); K3-NLMS against its
  plain version at S = 1024.
- Times (phases 6, 10, 15): kernels, plain versions and the paths, with
  CUDA events, beside the card's name and power limit.

One line per phase; the first failure exits nonzero (nothing is caught).
The second-to-last line is the ``kernels`` JSON (each kernel's launches on
its path, its error against its plain version, its time, its plain
version's time and its bound from this run's shapes), the last line the
``ok`` JSON. Exits nonzero without a CUDA device.
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
# K4 runs K1's and K2's device code in one launch: against the K1 + K2
# kernel route on the same input it is held to K2's bars. Against the plain
# composition, linear_wav is K1's output (K1's bar); wav and mask are K2's
# on an input that already differs by K1's round-off, which the sigmoid mask
# feels most on quiet residual frames: wav at K1's relative bar, mask at 1e-3
K4_WAV_TOL, K4_MASK_TOL = 1e-3, 1e-3
# K3 vs plain: one Kalman block and one LittleNet frame per stream and hop,
# state carried across 68 hops and 65 calls in another summation order ->
# K1's bar of 1e-3 of scale for the output blocks and for every state leaf
K3_TOL = 1e-3
STREAM_TOL = 2e-3  # streamed == offline, of signal scale (tests/test_streaming.py:37-39)
S_SERVE, HOP = 1024, 256  # bench config concurrent_streams: S streams, one 16 ms hop per call
# K5, K6, K7 vs plain: K1's bar and reason (another summation order carried
# by the recursion), of max|mic|
STAGE1_TOL = 1e-3
N_UTT = 256000  # bench configs #1 and #2: one 16 s utterance
N_FRAC = 40 * HOP + 77  # a hop-fractional single utterance

# The least time the card could take (PERF.md section 2): the larger of the
# fp32 operations over the FFMA peak and the bytes over the HBM rate, from
# the published H100 SXM figures at 700 W.
PEAK_FP32, PEAK_HBM = 67e12, 3.35e12
L_PART, K_BINS, RI, FRAME, BANDS = 10, 257, 514, 512, 32
# FMAs of one stage-1 block step per utterance: far-frame analysis, echo
# synthesis, residual analysis, constraint head and tail over L partitions
# (the elementwise work, ~3 % more, is left out: a bound may undercount)
STAGE1_FMA = FRAME * RI + RI * HOP + HOP * RI + 2 * L_PART * RI * HOP
# one LittleNet frame: both analyses, both ERB projections, GRU input and
# hidden projections, lin1, lin2, the ERB back-projection, pinv synthesis
STAGE2_FMA = (2 * FRAME * RI + 2 * K_BINS * BANDS + 3 * BANDS * 3 * BANDS + 2 * BANDS * BANDS
              + BANDS * BANDS + K_BINS * BANDS + RI * FRAME)
STAGE1_BASES = 4 * (FRAME * RI + 2 * RI * HOP)  # fwd, inv_tail, inv_head: bytes
STAGE2_BASES = 4 * (FRAME * RI + RI * FRAME + 2 * K_BINS * BANDS + 12 * BANDS * BANDS)


def bound(fma: float, nbytes: float) -> dict:
    """``bound_ms`` and ``bound_by`` of the kernels JSON."""
    t_ops, t_bytes = 2 * fma / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def make_batch(dev, seed: int, b: int, n: int):
    """Far-end noise through a random decaying 512-tap echo path per
    utterance, plus a low near-end noise floor; made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    far = torch.randn(b, n, generator=g, device=dev)
    rir = torch.randn(b, 512, generator=g, device=dev)
    rir = rir * torch.exp(-torch.arange(512, device=dev) / 100.0)
    rir = 0.5 * rir / rir.abs().amax(-1, keepdim=True)
    nfft = n + 512
    echo = torch.fft.irfft(torch.fft.rfft(far, nfft) * torch.fft.rfft(rir, nfft), nfft)[:, :n]
    mic = echo + 0.01 * torch.randn(b, n, generator=g, device=dev)
    return far.contiguous(), mic.contiguous()


def state_err(got: dict, want: dict) -> tuple[str, float]:
    """The serving-state leaf (``nm`` row by row) with the largest
    max|got - want| relative to the leaf's own scale, and that ratio."""
    pairs = {k: (got[k], want[k]) for k in want if k != "nm"}
    pairs.update({f"nm[{r}]": (got["nm"][:, r], want["nm"][:, r]) for r in range(8)})
    errs = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)
            for k, (a, b) in pairs.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def drive(kernels, fn):
    """The contract of a path's run: every launch count set to 0 just before
    ``fn`` drives the path, read just after; -> (fn's result, the counts)."""
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches for k in kernels]


def serve_pair(net, erb, far, mic, k_calls, stage1="kalman", **kw):
    """K3 and serving_step_plain side by side over ``k_calls`` (a list of
    blocks per call); returns both states, the worst output max|d| relative
    to its call's output scale, and the worst max|d| itself."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    s = far.shape[0]
    ks, ps = (serving_init(s, stage1=stage1, device=far.device) for _ in range(2))
    kw["stage1"] = stage1
    rel, err, lo = 0.0, 0.0, 0
    for k in k_calls:
        fb, mb = far[:, lo : lo + k * HOP].contiguous(), mic[:, lo : lo + k * HOP].contiguous()
        ks, ok = serving_step_fused(net, ks, fb, mb, erb, **kw)
        ps, op = serving_step_plain(net, ps, fb, mb, erb, **kw)
        check(ok.shape == (s, k * HOP) and bool(torch.isfinite(ok).all()), "K3 output")
        d = float((ok - op).abs().max())
        rel, err = max(rel, d / max(float(op.abs().max()), 1e-9)), max(err, d)
        lo += k * HOP
    return ks, ps, rel, err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels import _build
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        single_stream_lib,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.stage2 import (
        little_net_apply_fused,
        little_net_apply_fused_plain,
    )
    from aec_tpu_torch.kernels.serving import (
        serving_init,
        serving_state_to_stream,
        serving_step_fused,
        serving_step_plain,
    )
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.pipeline.streaming import stream_flush
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

    # 3. build the kernels from the checkout's sources (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    logs = _build.build("kalman_batched", "stage2", "serving", "two_stage", "nlms_batched",
                        "single_stream")
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
    far, mic = make_batch(dev, args.seed, BATCH, N)
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
    sf, sm = torch.from_numpy(s_far).to(dev), torch.from_numpy(s_mic).to(dev)
    out, launches = drive((kalman_cancel_fused_batched, little_net_apply_fused),
                          lambda: two_stage_cancel(net, sf, sm, erb))
    phase("main path", f"two_stage_cancel 8 x {N}: launches K1 {launches[0]}, K2 {launches[1]}")
    check(all(n > 0 for n in launches), "the main path did not go through every kernel")
    out = {k: v.cpu().numpy() for k, v in out.items()}
    check(out["wav"].shape == s_mic.shape and np.isfinite(out["wav"]).all(), "two_stage output")
    plain_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz"),
                                 torch.from_numpy(s_far), torch.from_numpy(s_mic), erb_filterbank())
    with open("benchmarks/results/checkpoint_quality_r3.json") as f:
        jax_grades = json.load(f)["robust"]
    phase("scenes", "tail ERLE dB: stage1 kernel/plain, two-stage kernel/plain | JAX grade "
          "(robust, 4.1 s scenes, TPU v5e; information only)")
    worst = 0.0
    for i, k in enumerate(names):
        s1 = (erle_tail(s_mic[i], out["linear_wav"][i]),
              erle_tail(s_mic[i], plain_ref["linear_wav"][i].numpy()))
        s2 = erle_tail(s_mic[i], out["wav"][i]), erle_tail(s_mic[i], plain_ref["wav"][i].numpy())
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

    # 7. K4 vs the K1 + K2 kernel route and vs its plain composition at the
    #    full shape; then the fast route
    with torch.no_grad():
        f_k = two_stage_fused(net, far, mic, erb)
        f_c = two_stage_cancel(net, far, mic, erb)
        f_p = two_stage_fused_plain(net, far, mic, erb)
        torch.cuda.synchronize()
    check(f_k["wav"].shape == mic.shape and bool(torch.isfinite(f_k["wav"]).all())
          and f_k["mask"].shape == (BATCH, N // HOP + 1, 32), "K4 output")
    k4_scale = float(f_p["wav"].abs().max())
    for ref, label, bars in (
        (f_c, "K4 vs K1+K2", (K1_TOL * mic_scale, K2_WAV_TOL * k4_scale, K2_MASK_TOL)),
        (f_p, "K4 vs plain", (K1_TOL * mic_scale, K4_WAV_TOL * k4_scale, K4_MASK_TOL)),
    ):
        errs = [float((f_k[key] - ref[key]).abs().max()) for key in ("linear_wav", "wav", "mask")]
        phase(label, ", ".join(f"{key} max|d| = {e:.3e} (bar {b:.3e})" for key, e, b in
                               zip(("linear_wav", "wav", "mask"), errs, bars)))
        check(all(e <= b for e, b in zip(errs, bars)), f"{label}: K4 disagrees")
    k4_err = errs[1]
    del f_k, f_c, f_p
    fast, (k4_launches,) = drive((two_stage_fused,),
                                 lambda: two_stage_cancel(net, sf, sm, erb, quality="fast"))
    phase("fast path", f"two_stage_cancel(quality='fast') 8 x {N}: launches K4 {k4_launches}")
    check(k4_launches > 0, "the fast path did not go through K4")
    fast = {k: v.cpu().numpy() for k, v in fast.items()}
    worst = max(abs(erle_tail(s_mic[i], fast[key][i]) - erle_tail(s_mic[i], out[key][i]))
                for i in range(len(names)) for key in ("linear_wav", "wav"))
    phase("fast path", f"worst |fast - parity route| tail ERLE over the 8 scenes = {worst:.4f} dB "
          f"(bar {ERLE_TOL_DB} dB)")
    check(worst <= ERLE_TOL_DB, "the fast route and the parity route disagree in tail ERLE")

    # 8. K3 vs plain at S = 1024 live streams: 64 one-hop calls, one k = 4 call
    s_far_d, s_mic_d = make_batch(dev, args.seed + 1, S_SERVE, 68 * HOP)
    with torch.no_grad():
        ks, ps, k3_rel, k3_err = serve_pair(net, erb, s_far_d, s_mic_d, [1] * 64 + [4])
        torch.cuda.synchronize()
        leaf, leaf_rel = state_err(ks, ps)
        phase("K3 vs plain", f"S = {S_SERVE}, 64 x k=1 + 1 x k=4: out max|d| / scale = "
              f"{k3_rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
        check(k3_rel <= K3_TOL and leaf_rel <= K3_TOL, "K3 disagrees with its plain version")
        ks_n, ps_n, n_rel, _ = serve_pair(net, erb, s_far_d[:128], s_mic_d[:128], [1] * 8 + [3] * 4,
                                       normalize=True, gain_norm=True)
        torch.cuda.synchronize()
        leaf_n, leaf_n_rel = state_err(ks_n, ps_n)
        phase("K3 vs plain", f"S = 128, normalize + gain_norm, 8 x k=1 + 4 x k=3: out "
              f"{n_rel:.3e}, worst state leaf {leaf_n} {leaf_n_rel:.3e} (bar {K3_TOL:g})")
        check(n_rel <= K3_TOL and leaf_n_rel <= K3_TOL,
              "K3 (normalize, gain_norm) disagrees with its plain version")

    # 9. the serving path: the 8 scenes streamed hop by hop through K3, then
    #     serving_state_to_stream + stream_flush, against offline two_stage_cancel
    def stream_scenes(stage1):
        st, blocks = serving_init(len(names), stage1=stage1, device=dev), []
        for lo in range(0, N, HOP):
            st, o = serving_step_fused(net, st, sf[:, lo : lo + HOP].contiguous(),
                                       sm[:, lo : lo + HOP].contiguous(), erb, stage1=stage1)
            blocks.append(o)
        blocks.append(stream_flush(net, serving_state_to_stream(st, stage1=stage1), erb))
        return torch.cat(blocks, -1)[:, HOP:].cpu().numpy()

    with torch.no_grad():
        streamed, (k3_launches,) = drive((serving_step_fused,), lambda: stream_scenes("kalman"))
    phase("serving path", f"8 scenes x {N // HOP} hops through serving_step_fused: launches K3 "
          f"{k3_launches}")
    check(k3_launches > 0, "the serving path did not go through K3")
    check(streamed.shape == s_mic.shape and np.isfinite(streamed).all(), "streamed output")
    s_rel = float(np.max(np.abs(streamed - out["wav"]))) / float(np.max(np.abs(out["wav"])))
    s_db = max(abs(erle_tail(s_mic[i], streamed[i]) - erle_tail(s_mic[i], out["wav"][i]))
               for i in range(len(names)))
    phase("serving path", f"streamed vs offline: max|d| / scale = {s_rel:.3e} (bar {STREAM_TOL:g}), "
          f"worst tail ERLE |d| = {s_db:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(s_rel <= STREAM_TOL and s_db <= ERLE_TOL_DB, "streamed output disagrees with offline")

    # 10. times of K3 and K4 (median of --reps, CUDA events)
    blk_f, blk_m = s_far_d[:, :HOP].contiguous(), s_mic_d[:, :HOP].contiguous()
    with torch.no_grad():
        t_k3 = time_ms(lambda: serving_step_fused(net, ks, blk_f, blk_m, erb), args.reps)
        t_p3 = time_ms(lambda: serving_step_plain(net, ps, blk_f, blk_m, erb), args.reps)
        t_k4 = time_ms(lambda: two_stage_fused(net, far, mic, erb), args.reps)
        t_p4 = time_ms(lambda: two_stage_fused_plain(net, far, mic, erb), args.reps)
    streams = S_SERVE * (HOP / SR * 1e3) / t_k3
    phase("time", f"K3 S = {S_SERVE}, k = 1: {t_k3:.3f} ms per call (plain {t_p3:.3f} ms) = "
          f"{streams:.0f} concurrent realtime streams [{smi}]")
    phase("time", f"K4 {BATCH} x {N}: {t_k4:.2f} ms (composition two_stage_cancel {t_all:.2f} ms, "
          f"plain {t_p4:.2f} ms) [{smi}]")
    print(f"serving_ms={t_k3:.4f} streams={streams:.0f} two_stage_fused_ms={t_k4:.3f}", flush=True)

    # 11. K5 vs its plain version at the main path's full shape
    ncfg = NlmsConfig()
    with torch.no_grad():
        e_k = nlms_cancel_fused_batched(ncfg, far, mic)["wav"]
        e_p = nlms_cancel_plain(ncfg, far, mic)["wav"]
        torch.cuda.synchronize()
    k5_err = float((e_k - e_p).abs().max())
    check(e_k.shape == mic.shape and bool(torch.isfinite(e_k).all()), "K5 output")
    phase("K5 vs plain", f"{BATCH} x {N}, NlmsConfig(): max|d| = {k5_err:.3e}, bar "
          f"{STAGE1_TOL:g} x max|mic| = {STAGE1_TOL * mic_scale:.3e}")
    check(k5_err <= STAGE1_TOL * mic_scale, "K5 disagrees with its plain version")
    del e_k, e_p

    # 12. K6 and K7 vs plain on one 16 s utterance and a hop-fractional one,
    #     twice with other inputs (a race between the cluster's exchanges
    #     would show as a small, input-dependent error); K6 also against K1
    #     as a batch of one, the route it replaces
    single = {"K6": (kalman_cancel_fused, kalman_cancel_plain, cfg),
              "K7": (nlms_cancel_fused, nlms_cancel_plain, ncfg)}
    single_err = dict.fromkeys(single, 0.0)
    with torch.no_grad():
        for rep in range(2):
            for n in (N_UTT, N_FRAC):
                f1, m1 = (t[0] for t in make_batch(dev, args.seed + 10 + rep, 1, n))
                bar = STAGE1_TOL * float(m1.abs().max())
                for label, (fused, plain, c) in single.items():
                    got = fused(c, f1, m1)["wav"]
                    want = plain(c, f1, m1)["wav"]
                    torch.cuda.synchronize()
                    check(got.shape == (n,) and bool(torch.isfinite(got).all()), f"{label} output")
                    err = float((got - want).abs().max())
                    single_err[label] = max(single_err[label], err)
                    msg = f"n = {n}, inputs {rep}: max|d| = {err:.3e} (bar {bar:.3e})"
                    if label == "K6":
                        k1 = kalman_cancel_fused_batched(c, f1[None], m1[None])["wav"][0]
                        e1 = float((got - k1).abs().max())
                        msg += f"; vs K1 as a batch of one {e1:.3e}"
                        check(e1 <= bar, "K6 disagrees with K1 as a batch of one")
                    phase(f"{label} vs plain", msg)
                    check(err <= bar, f"{label} disagrees with its plain version")

    # 13. the 8 scenes with stage1="nlms": batched (K5 + K2), one by one on
    #     the single-stream route (K7 + K2), against the plain route on the
    #     CPU; and the single-stream Kalman route (K6 + K2) against phase 5's
    #     plain route. Each route is one path: counts set to 0, driven, read.
    def one_by_one(**kw):
        outs = [two_stage_cancel(net, sf[i], sm[i], erb, **kw) for i in range(len(names))]
        return {key: torch.stack([o[key] for o in outs]) for key in ("wav", "linear_wav")}

    with torch.no_grad():
        nl_out, (k5_launches, k2_nl) = drive(
            (nlms_cancel_fused_batched, little_net_apply_fused),
            lambda: two_stage_cancel(net, sf, sm, erb, stage1="nlms"))
        nl_one, (k7_launches, k2_n1) = drive((nlms_cancel_fused, little_net_apply_fused),
                                             lambda: one_by_one(stage1="nlms"))
        ka_one, (k6_launches, k2_k1) = drive((kalman_cancel_fused, little_net_apply_fused),
                                             lambda: one_by_one())
    phase("nlms path", f"two_stage_cancel(stage1='nlms') 8 x {N}: launches K5 {k5_launches}, "
          f"K2 {k2_nl}; one by one: launches K7 {k7_launches}, K2 {k2_n1}")
    phase("single path", f"two_stage_cancel 8 x [{N}] one by one: launches K6 {k6_launches}, "
          f"K2 {k2_k1}")
    check(min(k5_launches, k2_nl, k7_launches, k2_n1, k6_launches, k2_k1) > 0,
          "an NLMS or single-stream path did not go through its kernels")
    nl_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz"),
                              torch.from_numpy(s_far), torch.from_numpy(s_mic), erb_filterbank(),
                              stage1="nlms")
    routes = {"nlms batched": (nl_out, nl_ref), "nlms single": (nl_one, nl_ref),
              "kalman single": (ka_one, plain_ref)}
    phase("scenes", "tail ERLE dB, kernel route / plain route, stage 1 | two-stage")
    worst = dict.fromkeys(routes, 0.0)
    for i, k in enumerate(names):
        cells = []
        for route, (got, want) in routes.items():
            e = [(erle_tail(s_mic[i], got[key][i].cpu().numpy()),
                  erle_tail(s_mic[i], want[key][i].numpy())) for key in ("linear_wav", "wav")]
            worst[route] = max(worst[route], *(abs(a - b) for a, b in e))
            check(all(np.isfinite(v) for pair in e for v in pair), f"{route} ERLE on {k}")
            cells.append(f"{route} {e[0][0]:7.3f}/{e[0][1]:7.3f} | {e[1][0]:7.3f}/{e[1][1]:7.3f}")
        phase("scenes", f"{k:13s} " + "; ".join(cells))
    phase("scenes", "worst |kernel - plain| tail ERLE: " + ", ".join(
        f"{r} {w:.4f} dB" for r, w in worst.items()) + f" (bar {ERLE_TOL_DB} dB)")
    check(max(worst.values()) <= ERLE_TOL_DB, "an NLMS or single-stream route disagrees with plain")

    # 14. NLMS serving: the 8 scenes hop by hop through K3-NLMS + stream_flush
    #     against the offline NLMS route; then K3-NLMS vs plain at S = 1024
    with torch.no_grad():
        streamed_n, (k3n_launches,) = drive((serving_step_fused,), lambda: stream_scenes("nlms"))
    off_n = nl_out["wav"].cpu().numpy()
    check(k3n_launches > 0, "the NLMS serving path did not go through K3")
    check(streamed_n.shape == s_mic.shape and np.isfinite(streamed_n).all(), "NLMS streamed output")
    sn_rel = float(np.max(np.abs(streamed_n - off_n))) / float(np.max(np.abs(off_n)))
    sn_db = max(abs(erle_tail(s_mic[i], streamed_n[i]) - erle_tail(s_mic[i], off_n[i]))
                for i in range(len(names)))
    phase("nlms serving path", f"8 scenes x {N // HOP} hops: launches K3-NLMS {k3n_launches}; "
          f"streamed vs offline max|d| / scale = {sn_rel:.3e} (bar {STREAM_TOL:g}), worst tail "
          f"ERLE |d| = {sn_db:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(sn_rel <= STREAM_TOL and sn_db <= ERLE_TOL_DB, "NLMS streamed output disagrees with offline")
    with torch.no_grad():
        ks_n, ps_n, k3n_rel, k3n_err = serve_pair(net, erb, s_far_d, s_mic_d, [1] * 64 + [4],
                                                  stage1="nlms")
        torch.cuda.synchronize()
    leaf, leaf_rel = state_err(ks_n, ps_n)
    phase("K3-NLMS vs plain", f"S = {S_SERVE}, 64 x k=1 + 1 x k=4: out max|d| / scale = "
          f"{k3n_rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
    check(k3n_rel <= K3_TOL and leaf_rel <= K3_TOL, "K3-NLMS disagrees with its plain version")

    # 15. times of K5 (in turns with K1: K1, K5, K5, K1), K6, K7, the
    #     single-utterance paths and their stage 2 alone, and K3-NLMS
    #     (median of --reps, CUDA events)
    f16, m16 = (t[0] for t in make_batch(dev, args.seed + 20, 1, N_UTT))
    utt_s = N_UTT / SR
    with torch.no_grad():
        turns = [time_ms(lambda: fn(c, far, mic), args.reps) for fn, c in (
            (kalman_cancel_fused_batched, cfg), (nlms_cancel_fused_batched, ncfg),
            (nlms_cancel_fused_batched, ncfg), (kalman_cancel_fused_batched, cfg))]
        t_k5 = statistics.median(turns[1:3])
        t_p5 = time_ms(lambda: nlms_cancel_plain(ncfg, far, mic), args.reps)
        t_k6 = time_ms(lambda: kalman_cancel_fused(cfg, f16, m16), args.reps)
        t_p6 = time_ms(lambda: kalman_cancel_plain(cfg, f16, m16), args.reps)
        t_k7 = time_ms(lambda: nlms_cancel_fused(ncfg, f16, m16), args.reps)
        t_p7 = time_ms(lambda: nlms_cancel_plain(ncfg, f16, m16), args.reps)
        t_k1_one = time_ms(lambda: kalman_cancel_fused_batched(cfg, f16[None], m16[None]),
                           args.reps)
        lin16 = kalman_cancel_fused(cfg, f16, m16)["wav"].reshape(1, -1, HOP)
        t_k2_one = time_ms(lambda: little_net_apply_fused(net, lin16, f16.reshape(1, -1, HOP), erb),
                           args.reps)
        t_utt_k = time_ms(lambda: two_stage_cancel(net, f16, m16, erb), args.reps)
        t_utt_n = time_ms(lambda: two_stage_cancel(net, f16, m16, erb, stage1="nlms"), args.reps)
        t_k3n = time_ms(lambda: serving_step_fused(net, ks_n, blk_f, blk_m, erb, stage1="nlms"),
                        args.reps)
        t_p3n = time_ms(lambda: serving_step_plain(net, ps_n, blk_f, blk_m, erb, stage1="nlms"),
                        args.reps)
    streams_n = S_SERVE * (HOP / SR * 1e3) / t_k3n
    phase("time", f"K5 {BATCH} x {N}: {t_k5:.2f} ms (plain {t_p5:.2f} ms); in turns K1 / K5 / K5 / "
          f"K1: {' / '.join(f'{t:.2f}' for t in turns)} ms [{smi}]")
    phase("time", f"one 16 s utterance: K6 {t_k6:.3f} ms (plain {t_p6:.2f} ms), K7 {t_k7:.3f} ms "
          f"(plain {t_p7:.2f} ms), one cluster of {single_stream_lib().aec_single_cluster()} "
          f"CTAs; K1 as a batch of one {t_k1_one:.2f} ms [{smi}]")
    phase("time", f"two_stage_cancel one 16 s utterance: Kalman {t_utt_k:.2f} ms = "
          f"{utt_s / (t_utt_k / 1e3):.1f} x realtime, NLMS {t_utt_n:.2f} ms = "
          f"{utt_s / (t_utt_n / 1e3):.1f} x realtime; its stage 2, K2 as a batch of one, "
          f"{t_k2_one:.2f} ms [{smi}]")
    phase("time", f"K3-NLMS S = {S_SERVE}, k = 1: {t_k3n:.3f} ms per call (plain {t_p3n:.3f} ms) "
          f"= {streams_n:.0f} concurrent realtime streams [{smi}]")
    print(f"nlms_batched_ms={t_k5:.3f} kalman_single_ms={t_k6:.4f} nlms_single_ms={t_k7:.4f} "
          f"serving_nlms_ms={t_k3n:.4f} streams_nlms={streams_n:.0f}", flush=True)

    # 16. the kernels of the paths, with this run's numbers; bounds from
    #     this run's shapes (module top), no single PyTorch call computes any
    #     of these recursions, so library_ms is null
    t_main, t_utt = N // HOP, -(-N_UTT // HOP)
    state_bytes = {k: 4 * sum(v.numel() for v in st.values()) // S_SERVE
                   for k, st in (("kalman", ks), ("nlms", ks_n))}
    serve_io = 3 * S_SERVE * HOP * 4 + STAGE1_BASES + STAGE2_BASES
    stage1_batch = bound(BATCH * t_main * STAGE1_FMA, 3 * BATCH * N * 4 + STAGE1_BASES)
    stage1_one = bound(t_utt * STAGE1_FMA, 3 * N_UTT * 4 + STAGE1_BASES)
    masks = BATCH * (t_main + 1) * BANDS * 4
    rows = [
        ("kalman_batched", "kalman_batched.cu", "pallas_kalman.py:492", launches[0], k1_err,
         t_k1, t_p1, stage1_batch),
        ("stage2", "stage2.cu", "pallas_stage2.py:100", launches[1], k2_err, t_k2, t_p2,
         bound(BATCH * (t_main + 1) * STAGE2_FMA, 3 * BATCH * N * 4 + masks + STAGE2_BASES)),
        ("serving", "serving.cu", "pallas_serving.py:239", k3_launches, k3_err, t_k3, t_p3,
         bound(S_SERVE * (STAGE1_FMA + STAGE2_FMA), serve_io + 2 * S_SERVE * state_bytes["kalman"])),
        ("serving_nlms", "serving.cu", "pallas_serving.py:239", k3n_launches, k3n_err, t_k3n,
         t_p3n, bound(S_SERVE * (STAGE1_FMA + STAGE2_FMA),
                      serve_io + 2 * S_SERVE * state_bytes["nlms"])),
        ("two_stage", "two_stage.cu", "pallas_two_stage.py:134", k4_launches, k4_err, t_k4, t_p4,
         bound(BATCH * (t_main * STAGE1_FMA + (t_main + 1) * STAGE2_FMA),
               4 * BATCH * N * 4 + masks + STAGE1_BASES + STAGE2_BASES)),
        ("nlms_batched", "nlms_batched.cu", "pallas_nlms.py:242", k5_launches, k5_err, t_k5, t_p5,
         stage1_batch),
        ("kalman_single", "single_stream.cu", "pallas_kalman.py:150", k6_launches,
         single_err["K6"], t_k6, t_p6, stage1_one),
        ("nlms_single", "single_stream.cu", "pallas_nlms.py:94", k7_launches, single_err["K7"],
         t_k7, t_p7, stage1_one),
    ]
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"aec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"aec_tpu/kernels/{tpu}", "launches": n, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, **bnd, "library_ms": None}
        for kernel, src, tpu, n, err, ms, plain_ms, bnd in rows
    ]}), flush=True)
    # 17. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
