"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Runs ``aec_tpu_torch`` (never JAX): builds the ten CUDA sources in the
checkout (twelve kernels), in parallel, and drives every user-facing path.

- Offline Kalman (phases 4, 5, 7): each kernel against its plain PyTorch
  version at the main path's full shape (batch 256 x 131,072 samples =
  8.2 s at 16 kHz, L=10 / block 256 / K=257, the width-1 LittleNet of
  ``checkpoints/little_net_robust.npz``), K2's mask also against the plain
  version evaluated in fp64 (there and on full-scale noise through four
  untrained nets, beside TF32 products as the lower-precision control);
  ``two_stage_cancel`` on the 8 scenes of ``benchmarks/scenes.py``, graded
  against the plain (CPU) route; the ``quality="fast"`` route, which runs
  the whole pipeline as K4.
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
- Training (phases 16-19): K8 (the GRU scan) against its plain version at
  B = 1 x 1001 frames (H = 32 and 128) and B = 16 x 501, its gradients
  against the plain route's, beside cuDNN's ``nn.GRU``; the trainer of a
  width-1 LittleNet at ``TrainConfig()``: 5 steps at batch 16 x 8 s (the
  first against the CPU route), validation at batch 1 through K8, a
  checkpoint round trip, 3 batch-1 steps; the width-4 net on one utterance
  at a time (K6 + K8) against the CPU route.
- K12 (phase 20): the spectra-in batched Kalman entry against K1 and its
  plain version at the main shape.
- Other geometries (phase 21): the 8 scenes at 4 and 16 partitions (block
  256) and at the 320 / 160 / 320 STFT through K1, K5, K6, K7, K12, K2, K4
  and K3 (both filters) against their plain versions, and through
  ``two_stage_cancel``'s batched, fast and single-utterance routes; then
  K1, K12, K5, K6, K7, K4 and K3 (both filters) each at the largest
  partition count its wrapper accepts at blocks 256 and 160, against the
  plain versions, and one partition more, which must be refused for
  shared memory.
- K8 wide (phase 16): H = 64, 128, 129 and 512 beside cuDNN's ``nn.GRU``.
- DCCRN inference (phases 22-23): K9 (the grouped complex LSTM) at
  ``DccrnConfig()``'s width (I = H = 1024 per part, T = 513) at B = 1 and 8
  against its plain version, beside the plain scan and cuDNN's ``nn.LSTM``;
  ``cli/infer``'s DCCRN enhancer (Kalman stage 1) on the 8 scenes one by
  one, kernel route (K1 + K9) against the plain route, cuDNN's TF32 off.
- FullSubNet inference (phase 24): K11 (the joint full-band / sub-band
  LSTM recurrence) at ``FullSubNetConfig()``'s widths over 820 frames (8.2 s
  at hop 160) at B = 1 and 4 against its plain joint loop; ``cli/infer``'s
  FullSubNet enhancer (Kalman stage 1) on the 8 scenes one by one, kernel
  route (K1 + K11) against the plain route.
- ATT-CCRN inference (phase 25): K10 (the int8 LSTM recurrence) at the
  bottleneck's H = 4096, T = 513 against the plain int8 loop, with the count
  of h's int8 codes that differ; ``cli/infer``'s ATT-CCRN enhancer
  (``--lstm_dtype auto``: int8 on the card) on the 8 scenes, kernel route
  (K1 + K10) against the plain route, and its wav SNR against the f32 route.

One line per phase; the first failure exits nonzero (nothing is caught).
The second-to-last line is the ``kernels`` JSON (each kernel's launches on
its path, its error against its plain version, its time, its plain
version's time and its bound from this run's shapes), the last line the
``ok`` JSON. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# (on the main path also against the plain version evaluated in fp64)
K2_WAV_TOL, K2_MASK_TOL = 1e-4, 1e-5
# The mask's round-off grows with the input level and the net's gains. On
# full-scale noise through an untrained net each fp32 evaluation lands up to
# ~1.2e-5 from fp64 and K2 and the plain version up to ~1.4e-5 apart, while
# TF32 products (the lower-precision control) land 1.9e-2 to 3e-2 off: the
# mask bar there is 5e-5, and the control must stay at least 1e-3 off
K2_LOUD_MASK_TOL, K2_CONTROL_MIN = 5e-5, 1e-3
ERLE_TOL_DB = 0.1  # kernel route vs plain route, tail ERLE per scene
# K4 runs K1's and K2's device code in one launch: against the K1 + K2
# kernel route on the same input it is held to K2's bars. Against the plain
# composition, linear_wav is K1's output (K1's bar); wav and mask are K2's
# on an input that already differs by K1's round-off, which the sigmoid mask
# feels most on quiet residual frames: wav at K1's relative bar, mask at 1e-3
K4_WAV_TOL, K4_MASK_TOL = 1e-3, 1e-3
# K8 vs plain: h lies in [-1, 1]; an fp32 recursion summed in another order
K8_TOL = 1e-5
# gradients through K8 vs the plain route (both backwards recompute the plain
# scan; only the forward's round-off differs): 1e-4 of each leaf's scale
K8_GRAD_TOL = 1e-4
# the first train step vs the same step on the CPU route: fp32 round-off of
# STFT, GRU and backward in another order -> loss rtol 1e-4; Adam's first
# update is lr * g / (|g| + eps), so each leaf's mean |difference| <= 1e-3 lr
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-4, 1e-3
N_TRAIN = 128000  # bench config #7: 8 s utterances (501 frames), batch TrainConfig().batch_size
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
# the other geometries the stage-1/2 kernels take: (partitions, block == hop)
GEOMETRIES = ((4, 256), (16, 256), (10, 160))
# K9 vs plain: h lies in [-1, 1]; an fp32 recursion summed in another order
K9_TOL = 1e-5
# the DCCRN enhancer, kernel route vs plain route: K1's round-off enters
# DCCRN's input, which its convolutions and recurrence carry to the wav
DCCRN_WAV_TOL = 1e-3
T_DCCRN = N // HOP + 1  # frames of one 8.2 s utterance: 513
# K11 vs plain: h in [-1, 1], an fp32 recursion summed in another order
K11_TOL = 1e-5
T_FSN = N // 160 + 1  # frames of one 8.2 s utterance at FullSubNet's hop of 160: 820
# K10 vs the plain int8 loop: the same operations in the same order, so a code
# of h flips only where a transcendental differs by an ulp near a half; a flip
# moves one h_q by 1/127, which the recurrence carries -> 1e-2 absolute
K10_TOL = 1e-2
# each enhancer, kernel route vs plain route (the DCCRN bar and reason)
ENHANCER_WAV_TOL = 1e-3
# ATT-CCRN's int8 route against its f32 route, wav SNR per scene (the JAX
# package graded 71.45-76.41 dB against bf16, benchmarks/results/ab_lstm_int8_r4.json)
INT8_SNR_MIN_DB = 60.0

# The least time the card could take (PERF.md section 2): the larger of the
# fp32 operations over the FFMA peak and the bytes over the HBM rate, from
# the published H100 SXM figures at 700 W.
PEAK_FP32, PEAK_HBM, PEAK_INT8 = 67e12, 3.35e12, 1979e12
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


def fsn_bound(b: int, t: int, f: int = 161, hf: int = 256, hs: int = 96) -> dict:
    """K11's: per frame the full-band, embedding, sub-band and embedding-column
    FMAs; xp_fb, xp_sb, the weights in, ys out."""
    fma = t * b * (4 * hf * hf + f * hf + f * 4 * hs * hs + f * 4 * hs)
    return bound(fma, 4 * (b * t * (4 * hf + f * 4 * hs + f * hs)
                           + 4 * hf * hf + f * hf + f + 4 * hs + 4 * hs * hs))


def int8_bound(b: int, t: int, h: int) -> dict:
    """K10's: B T 4H H int8 MACs at the int8 peak; the codes (1 B each),
    xp, scale, b_hh, h0, c0 in, ys and c_T out (fp32)."""
    return bound(b * t * 4 * h * h, 4 * h * h + 4 * (b * t * 4 * h + 2 * 4 * h + 3 * b * h
                                                     + b * t * h), PEAK_INT8)


def time_once(fn) -> float:
    """One run of ``fn`` on CUDA events (for plain loops too slow to repeat;
    the comparison run before it was the warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def gru_bound(b: int, t: int, h: int) -> dict:
    """K8's: B*T*3H*H FMA; xp in, ys out, W_hh^T, b_hn, h0 and h_T."""
    return bound(b * t * 3 * h * h, 4 * (b * t * 4 * h + 3 * h * h + h + 2 * b * h))


def bound(fma: float, nbytes: float, peak: float = PEAK_FP32) -> dict:
    """``bound_ms`` and ``bound_by`` of the kernels JSON: ``fma``
    multiply-adds at ``peak`` operations per second (fp32 unless named)."""
    t_ops, t_bytes = 2 * fma / peak * 1e3, nbytes / PEAK_HBM * 1e3
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


def serve_pair(net, erb, far, mic, k_calls, stage1="kalman", hop=HOP, **kw):
    """K3 and serving_step_plain side by side over ``k_calls`` (a list of
    blocks per call); returns both states, the worst output max|d| relative
    to its call's output scale, and the worst max|d| itself. ``kw`` may
    name the filter's ``kcfg`` and the ``scfg`` of a ``hop``-sample STFT."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    s = far.shape[0]
    geometry = {k: kw[k] for k in ("kcfg", "scfg") if k in kw}
    ks, ps = (serving_init(s, stage1=stage1, device=far.device, **geometry) for _ in range(2))
    kw["stage1"] = stage1
    rel, err, lo = 0.0, 0.0, 0
    for k in k_calls:
        fb, mb = far[:, lo : lo + k * hop].contiguous(), mic[:, lo : lo + k * hop].contiguous()
        ks, ok = serving_step_fused(net, ks, fb, mb, erb, **kw)
        ps, op = serving_step_plain(net, ps, fb, mb, erb, **kw)
        check(ok.shape == (s, k * hop) and bool(torch.isfinite(ok).all()), "K3 output")
        d = float((ok - op).abs().max())
        rel, err = max(rel, d / max(float(op.abs().max()), 1e-9)), max(err, d)
        lo += k * hop
    return ks, ps, rel, err


def leaves(tree) -> list[np.ndarray]:
    """A checkpoint tree's leaves in path order, as numpy arrays."""
    from aec_tpu_torch.train.checkpoints import tree_map_with_path

    out = []
    tree_map_with_path(tree, lambda _, v: out.append(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)))
    return out


def gru_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """16. K8 vs its plain version and beside cuDNN's nn.GRU (same weights,
    fp32) at one 16 s utterance (B = 1, T = 1001) for H = 32, 64 and 128 (one
    CTA per row) and 129 and 512 (the wide path on a grid of CTAs), and at
    the training batch (B = 16, T = 501, H = 32: the fused route called
    explicitly, for information; the routing stays JAX's B == 1)."""
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence, gru_recurrence_plain
    from aec_tpu_torch.ops.gru import gru_init

    g = torch.Generator().manual_seed(seed)
    out = {"err": 0.0, "shapes": {}}
    for b, t, h in ((1, 1001, 32), (1, 1001, 64), (1, 1001, 128), (1, 1001, 129),
                    (1, 1001, 512), (16, 501, 32)):
        params = gru_init(2 * BANDS, h, generator=g, device=dev)
        x = torch.randn(b, t, 2 * BANDS, generator=g).to(dev)
        h0 = torch.zeros(b, h, device=dev)
        gru = torch.nn.GRU(2 * BANDS, h, batch_first=True).to(dev)
        with torch.no_grad():
            for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                              ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(gru, name).copy_(params[key])
            xp, b_hn = folded_projection(params, x), params["b_hh"][2 * h:]
            ys = gru_recurrence(xp, params["w_hh"], b_hn, h0)
            want = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0)
            lib = gru(x, h0[None])[0]
            torch.cuda.synchronize()
            check(ys.shape == (b, t, h) and bool(torch.isfinite(ys).all()), "K8 output")
            err = float((ys - want).abs().max())
            lib_err = float((lib - want).abs().max())
            t_k = time_ms(lambda: gru_recurrence(xp, params["w_hh"], b_hn, h0), reps)
            t_p = time_ms(lambda: gru_recurrence_plain(xp, params["w_hh"], b_hn, h0), reps)
            t_lib = time_ms(lambda: gru(x, h0[None]), reps)
        phase("K8 vs plain", f"B = {b}, T = {t}, H = {h}: max|d| = {err:.3e} (bar {K8_TOL:g}); "
              f"cuDNN nn.GRU vs plain {lib_err:.3e} (information)")
        check(err <= K8_TOL, "K8 disagrees with its plain version")
        phase("time", f"K8 B = {b}, T = {t}, H = {h}: {t_k:.4f} ms (plain {t_p:.2f} ms, cuDNN "
              f"nn.GRU {t_lib:.4f} ms) [{smi}]")
        out["err"] = max(out["err"], err)
        out["shapes"][(b, t, h)] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_lib}
    return out


def trainer_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """17-18. K8's gradients against the plain route on one 8 s scene; the
    trainer at TrainConfig() on 16 utterances x 8 s (bench config #7): 5
    batch-16 steps (the first against the CPU route), validation at batch 1
    over 8 scenes (K8), a checkpoint round trip, 3 batch-1 steps (K8)."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.gru import gru_recurrence
    from aec_tpu_torch.models.little_net import (
        _pseudo_norm,
        little_net_features,
        little_net_init,
        little_net_loss,
    )
    from aec_tpu_torch.ops.gru import gru_scan
    from aec_tpu_torch.train import checkpoints
    from aec_tpu_torch.train.loop import (
        make_eval_step,
        make_optimizer,
        make_train_step,
        restore_train_tree,
        train_tree,
    )
    from benchmarks.scenes import make_scenes

    cfg = TrainConfig()
    scenes = [sc for sd in (seed, seed + 1)
              for sc in make_scenes(np.random.default_rng(sd), n=N_TRAIN).values()]
    far, mic, near = (torch.from_numpy(np.stack([sc[i] for sc in scenes])) for i in range(3))
    fd, md, nd = far.to(dev), mic.to(dev), near.to(dev)
    erb_c = torch.from_numpy(erb_filterbank())
    erb_d = erb_c.to(dev)
    net = little_net_init(generator=torch.Generator().manual_seed(seed), device=dev)
    cpu_net = little_net_init(generator=torch.Generator().manual_seed(seed), device="cpu")

    # 17. gradients through K8 vs the plain route: the GRU of the fresh net on
    #     one scene's features, a fixed random cotangent, every leaf
    with torch.no_grad():
        feats = little_net_features(_pseudo_norm(md[:1]), _pseudo_norm(fd[:1]), erb_d,
                                    StftConfig())[0]
    gp = {k: v.detach().clone().requires_grad_() for k, v in net.gru_params().items()}
    feats.requires_grad_()
    cot = torch.randn(1, feats.shape[1], net.hidden, generator=torch.Generator().manual_seed(seed))
    cot = cot.to(dev)
    grads, launches = {}, {}
    for fused in (None, False):
        (ys, _), (launches[fused],) = drive((gru_recurrence,), lambda: gru_scan(gp, feats,
                                                                                fused=fused))
        grads[fused] = torch.autograd.grad((ys * cot).sum(), [feats, *gp.values()])
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                for a, b in zip(grads[None], grads[False]))
    phase("K8 gradients", f"1 x {feats.shape[1]} frames: launches K8 {launches[None]} (plain route "
          f"{launches[False]}); worst leaf max|d| / scale = {worst:.3e} (bar {K8_GRAD_TOL:g})")
    check(launches[None] == 1 and launches[False] == 0, "the batch-1 route did not take K8")
    check(worst <= K8_GRAD_TOL, "gradients through K8 disagree with the plain route")

    # 18. the trainer: 5 steps at batch 16, the first also on the CPU route
    opt, cpu_opt = make_optimizer(cfg, 1, net), make_optimizer(cfg, 1, cpu_net)
    step, cpu_step = make_train_step(little_net_loss, opt), make_train_step(little_net_loss, cpu_opt)
    losses, times = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(md, fd, nd, erb_d)))  # float() waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            cpu_loss = float(cpu_step(mic, far, near, erb_c))
            mean_d = max(float((p.detach().cpu() - q.detach()).abs().mean())
                         for p, q in zip(net.parameters(), cpu_net.parameters()))
            rel = abs(losses[0] / cpu_loss - 1.0)
            phase("trainer", f"step 1, batch {cfg.batch_size} x {N_TRAIN}: loss {losses[0]:.6f} "
                  f"(CPU route {cpu_loss:.6f}, rel {rel:.2e}, bar {STEP_LOSS_TOL:g}); worst leaf "
                  f"mean|d| after the update {mean_d:.3e} (bar {STEP_PARAM_TOL:g} x lr = "
                  f"{STEP_PARAM_TOL * cfg.lr:.1e})")
            check(rel <= STEP_LOSS_TOL and mean_d <= STEP_PARAM_TOL * cfg.lr,
                  "the first train step disagrees with the CPU route")
    check(all(np.isfinite(losses)), "train loss not finite")
    t_step = statistics.median(times[1:])
    train_xrt = cfg.batch_size * N_TRAIN / SR / (t_step / 1e3)
    phase("trainer", f"losses {', '.join(f'{v:.4f}' for v in losses)}; step ms "
          f"{', '.join(f'{v:.1f}' for v in times)}; median of steps 2-5 {t_step:.2f} ms = "
          f"train_xrt {train_xrt:.1f} [{smi}]")

    eval_step = make_eval_step(little_net_loss)

    def validate():
        return [eval_step(net, md[i:i + 1], fd[i:i + 1], nd[i:i + 1], erb_d) for i in range(8)]

    vals, (k8_val,) = drive((gru_recurrence,), validate)
    check(k8_val > 0, "batch-1 validation did not go through K8")
    check(all(bool(torch.isfinite(w).all()) and w.shape == (1, N_TRAIN) and bool(torch.isfinite(v))
              for v, w in vals), "validation output")
    t_val = time_ms(validate, reps) / 8
    phase("trainer", f"validation, 8 scenes at batch 1: launches K8 {k8_val}; cv loss "
          f"{np.mean([float(v) for v, _ in vals]):.4f}; {t_val:.2f} ms per utterance [{smi}]")

    with tempfile.TemporaryDirectory() as d:
        tree = train_tree(opt)
        latest = checkpoints.save_latest_best(d, tree, {"cur_epoch": 0}, True)
        want, got = leaves(tree), leaves(checkpoints.restore(latest, tree))
        same = len(want) == len(got) and all(np.array_equal(a, b) for a, b in zip(want, got))
        fresh = little_net_init(generator=torch.Generator().manual_seed(seed + 7), device=dev)
        fresh_opt = make_optimizer(cfg, 1, fresh)
        restore_train_tree(os.path.join(d, "best_loss.npz"), fresh_opt)
        same_net = all(torch.equal(a, b) for a, b in zip(net.parameters(), fresh.parameters()))
    phase("trainer", f"save_latest_best -> restore: {len(want)} leaves bit-equal {same}; "
          f"resumed net bit-equal {same_net}, count {fresh_opt.count}")
    check(same and same_net and fresh_opt.count == opt.count, "checkpoint round trip")

    def batch_one_steps():
        return [float(step(md[i:i + 1], fd[i:i + 1], nd[i:i + 1], erb_d)) for i in range(3)]

    b1_losses, (k8_b1,) = drive((gru_recurrence,), batch_one_steps)
    check(k8_b1 > 0 and all(np.isfinite(b1_losses)), "batch-1 steps did not go through K8")
    t_b1 = time_ms(lambda: step(md[3:4], fd[3:4], nd[3:4], erb_d), reps)
    phase("trainer", f"3 batch-1 steps: launches K8 {k8_b1}, losses "
          f"{', '.join(f'{v:.4f}' for v in b1_losses)}; {t_b1:.2f} ms per step [{smi}]")
    print(f"train_step_ms={t_step:.3f} train_xrt={train_xrt:.1f} train_step_b1_ms={t_b1:.3f} "
          f"validate_ms_per_utt={t_val:.3f}", flush=True)
    return {"k8_val": k8_val}


def geometry_phase(dev, net, names, s_far, s_mic, smi: str) -> None:
    """21. The stage-1/2 kernels at other geometries on the 8 scenes (cut to
    a block multiple), each against its plain version at the default
    geometry's bars; two_stage_cancel's routes at each, against the plain
    route in tail ERLE. One path per geometry and route: counts set to 0,
    driven, read."""
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.linear import overlap_save as ols
    from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
    from aec_tpu_torch.utils.weights import load_npz
    from benchmarks.scenes import erle_tail

    cpu_net = load_npz("checkpoints/little_net_robust.npz", device="cpu")
    for n_blocks, hop in GEOMETRIES:
        n = N // hop * hop
        scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
        erb_np = erb_filterbank(n_freqs=scfg.n_freqs)
        erb = torch.as_tensor(erb_np, device=dev)
        kc, nc = KalmanConfig(n_blocks=n_blocks), NlmsConfig(n_blocks=n_blocks)
        far = torch.from_numpy(np.ascontiguousarray(s_far[:, :n])).to(dev)
        mic = torch.from_numpy(np.ascontiguousarray(s_mic[:, :n])).to(dev)
        bar = STAGE1_TOL * float(mic.abs().max())
        tag = f"L = {n_blocks}, block {hop}"
        errs = {}
        with torch.no_grad():
            for name, fused, plain, c in (("K1", kalman_cancel_fused_batched, kalman_cancel_plain,
                                           kc),
                                          ("K5", nlms_cancel_fused_batched, nlms_cancel_plain, nc)):
                got, (k,) = drive((fused,), lambda: fused(c, far, mic, block=hop)["wav"])
                check(k == 1 and got.shape == mic.shape and bool(torch.isfinite(got).all()),
                      f"{name} at {tag}")
                errs[name] = float((got - plain(c, far, mic, block=hop)["wav"]).abs().max())
            for name, fused, plain, c in (("K6", kalman_cancel_fused, kalman_cancel_plain, kc),
                                          ("K7", nlms_cancel_fused, nlms_cancel_plain, nc)):
                got, (k,) = drive((fused,), lambda: [fused(c, far[i], mic[i], block=hop)["wav"]
                                                    for i in range(2)])
                check(k == 2, f"{name} at {tag}")
                errs[name] = max(float((g - plain(c, far[i], mic[i], block=hop)["wav"]).abs().max())
                                 for i, g in enumerate(got))
            x_ri = ols.far_end_spectra(far, hop).contiguous()
            d_blocks = mic.reshape(len(names), -1, hop)
            errs["K12"] = float((kalman_filter_fused_batched(kc, x_ri, d_blocks, block=hop)
                                 - kalman_filter_fused_batched_plain(kc, x_ri, d_blocks,
                                                                     block=hop)).abs().max())
            phase("geometry", f"{tag}: 8 scenes x {n}: max|d| vs plain " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()) + f" (bar {bar:.3e})")
            check(max(errs.values()) <= bar, f"a stage-1 kernel disagrees at {tag}")

            lin_b = kalman_cancel_plain(kc, far, mic, block=hop)["wav"].reshape(len(names), -1, hop)
            far_b = far.reshape(len(names), -1, hop)
            o_k, m_k = little_net_apply_fused(net, lin_b, far_b, erb, scfg)
            o_p, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb, scfg)
            k2 = (float((o_k - o_p).abs().max()), float((m_k - m_p).abs().max()))
            k2_bar = (K2_WAV_TOL * float(o_p.abs().max()), K2_MASK_TOL)
            f_k = two_stage_fused(net, far, mic, erb, kcfg=kc, scfg=scfg)
            f_p = two_stage_fused_plain(net, far, mic, erb, kcfg=kc, scfg=scfg)
            k4 = [float((f_k[key] - f_p[key]).abs().max()) for key in ("linear_wav", "wav", "mask")]
            k4_bar = (bar, K4_WAV_TOL * float(f_p["wav"].abs().max()), K4_MASK_TOL)
            phase("geometry", f"{tag}: K2 wav {k2[0]:.3e} (bar {k2_bar[0]:.3e}), mask {k2[1]:.3e} "
                  f"(bar {k2_bar[1]:g}); K4 " + ", ".join(
                      f"{key} {e:.3e} (bar {b:.3e})" for key, e, b in
                      zip(("linear_wav", "wav", "mask"), k4, k4_bar)))
            check(all(e <= b for e, b in zip(k2, k2_bar)), f"K2 disagrees at {tag}")
            check(all(e <= b for e, b in zip(k4, k4_bar)), f"K4 disagrees at {tag}")
            for stage1 in ("kalman", "nlms"):
                ks, ps, rel, _ = serve_pair(net, erb, far, mic, [1] * 40 + [4] * 4, hop=hop,
                                            stage1=stage1, kcfg=kc if stage1 == "kalman" else nc,
                                            scfg=scfg)
                leaf, leaf_rel = state_err(ks, ps)
                phase("geometry", f"{tag}: K3-{stage1} 8 streams, 40 x k=1 + 4 x k=4: out "
                      f"{rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
                check(rel <= K3_TOL and leaf_rel <= K3_TOL, f"K3-{stage1} disagrees at {tag}")

            routes = {
                "batch K1 + K2": ((kalman_cancel_fused_batched, little_net_apply_fused),
                                  lambda: two_stage_cancel(net, far, mic, erb, lin_cfg=kc,
                                                           scfg=scfg)),
                "fast K4": ((two_stage_fused,),
                            lambda: two_stage_cancel(net, far, mic, erb, lin_cfg=kc, scfg=scfg,
                                                     quality="fast")),
                "one by one K6 + K2": ((kalman_cancel_fused, little_net_apply_fused),
                                       lambda: {"wav": torch.stack([two_stage_cancel(
                                           net, far[i], mic[i], erb, lin_cfg=kc,
                                           scfg=scfg)["wav"] for i in range(len(names))])}),
            }
            want = two_stage_cancel(cpu_net, far.cpu(), mic.cpu(), erb_np, lin_cfg=kc,
                                    scfg=scfg)["wav"].numpy()
            for route, (kernels, fn) in routes.items():
                out, counts = drive(kernels, fn)
                check(min(counts) > 0, f"two_stage_cancel's {route} route at {tag} missed a kernel")
                wav = out["wav"].cpu().numpy()
                worst = max(abs(erle_tail(s_mic[i, :n], wav[i]) - erle_tail(s_mic[i, :n], want[i]))
                            for i in range(len(names)))
                phase("geometry", f"{tag}: two_stage_cancel {route}: launches {counts}; worst "
                      f"|kernel - plain| tail ERLE {worst:.4f} dB (bar {ERLE_TOL_DB} dB) [{smi}]")
                check(worst <= ERLE_TOL_DB, f"the {route} route disagrees at {tag}")


def largest_l(run) -> tuple[int, str]:
    """The largest partition count ``run(L)`` accepts, raising L from 1 until
    it refuses; the refusal must be for shared memory. -> (L, the refusal)."""
    for n_blocks in range(1, 257):
        try:
            run(n_blocks)
        except ValueError as e:
            check("shared memory" in str(e) and n_blocks > 1,
                  f"a refusal at L = {n_blocks} that is not for shared memory: {e}")
            return n_blocks - 1, str(e)
    raise SystemExit("chip_smoke: FAILED: no partition count up to 256 was refused")


def limits_phase(dev, net, seed: int, smi: str) -> None:
    """21b. Each kernel whose shared-memory layout grows with the partition
    count, at the largest L its wrapper accepts at blocks 256 and 160 (two
    full register chunks of partitions and more), against its plain version
    at the geometry phase's bars; one partition more must be refused."""
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.linear import overlap_save as ols

    for hop in (256, 160):
        scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
        erb = torch.as_tensor(erb_filterbank(n_freqs=scfg.n_freqs), device=dev)
        far, mic = make_batch(dev, seed + 30, 2, 200 * hop)
        tiny = far[:, :2 * hop].contiguous(), mic[:, :2 * hop].contiguous()
        bar = STAGE1_TOL * float(mic.abs().max())

        def stage1(fn, cfg, one):
            def run(n_blocks, f, m):
                if one:
                    f, m = f[0].contiguous(), m[0].contiguous()
                return {"wav": fn(cfg(n_blocks=n_blocks), f, m, block=hop)["wav"]}
            return run

        def spectra(fn):
            return lambda n_blocks, f, m: {"wav": fn(
                KalmanConfig(n_blocks=n_blocks), ols.far_end_spectra(f, hop).contiguous(),
                m.reshape(2, -1, hop).contiguous(), block=hop)}

        def fast(fn):
            return lambda n_blocks, f, m: fn(net, f, m, erb, kcfg=KalmanConfig(n_blocks=n_blocks),
                                             scfg=scfg)

        def serve(stage1_, cfg):
            def run(n_blocks, f, m):
                st = serving_init(2, kcfg=cfg(n_blocks=n_blocks), scfg=scfg, stage1=stage1_,
                                  device=dev)
                return serving_step_fused(net, st, f[:, :hop].contiguous(), m[:, :hop].contiguous(),
                                          erb, cfg(n_blocks=n_blocks), scfg, stage1=stage1_)
            return run

        def k4_bars(want):
            return {"linear_wav": bar, "wav": K4_WAV_TOL * float(want["wav"].abs().max()),
                    "mask": K4_MASK_TOL}

        cases = {  # name: (kernel route, plain route or None for K3, bars from plain's output)
            "K1": (stage1(kalman_cancel_fused_batched, KalmanConfig, False),
                   stage1(kalman_cancel_plain, KalmanConfig, False), None),
            "K12": (spectra(kalman_filter_fused_batched), spectra(kalman_filter_fused_batched_plain),
                    None),
            "K5": (stage1(nlms_cancel_fused_batched, NlmsConfig, False),
                   stage1(nlms_cancel_plain, NlmsConfig, False), None),
            "K6": (stage1(kalman_cancel_fused, KalmanConfig, True),
                   stage1(kalman_cancel_plain, KalmanConfig, True), None),
            "K7": (stage1(nlms_cancel_fused, NlmsConfig, True),
                   stage1(nlms_cancel_plain, NlmsConfig, True), None),
            "K4": (fast(two_stage_fused), fast(two_stage_fused_plain), k4_bars),
            "K3-kalman": (serve("kalman", KalmanConfig), None, None),
            "K3-nlms": (serve("nlms", NlmsConfig), None, None),
        }
        with torch.no_grad():
            for name, (run, plain, bars) in cases.items():
                n_max, refusal = largest_l(lambda n_blocks: run(n_blocks, *tiny))
                if plain is None:
                    stage1_ = name.split("-")[1]
                    cfg = (KalmanConfig if stage1_ == "kalman" else NlmsConfig)(n_blocks=n_max)
                    ks, ps, rel, _ = serve_pair(net, erb, far, mic, [1] * 40 + [4] * 4, hop=hop,
                                                stage1=stage1_, kcfg=cfg, scfg=scfg)
                    leaf, leaf_rel = state_err(ks, ps)
                    errs = {"out / scale": (rel, K3_TOL), f"state {leaf} / scale": (leaf_rel, K3_TOL)}
                else:
                    got, want = run(n_max, far, mic), plain(n_max, far, mic)
                    b = bars(want) if bars else {"wav": bar}
                    errs = {k: (float((got[k] - want[k]).abs().max()), b[k]) for k in b}
                torch.cuda.synchronize()
                phase("limits", f"{name} block {hop}: largest L {n_max}, max|d| vs plain " + ", ".join(
                    f"{k} {e:.3e} (bar {v:.3e})" for k, (e, v) in errs.items())
                    + f"; L {n_max + 1} refused: {refusal}")
                check(all(e <= v for e, v in errs.values()),
                      f"{name} disagrees with its plain version at its largest L ({n_max}, block {hop})")


def k2_against_fp64(net, lin_b, far_b, erb) -> dict:
    """K2's mask, the plain fp32 version's and the plain version's with TF32
    products (the lower-precision control), each as max|d| from the plain
    version evaluated in fp64 on the same fp32 inputs and weights."""
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain

    _, m_64 = little_net_apply_fused_plain(copy.deepcopy(net).double(), lin_b.double(),
                                           far_b.double(), erb.double())
    _, m_k = little_net_apply_fused(net, lin_b, far_b, erb)
    _, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, m_t = little_net_apply_fused_plain(net, lin_b, far_b, erb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    return {"K2": float((m_k.double() - m_64).abs().max()),
            "plain": float((m_p.double() - m_64).abs().max()),
            "tf32": float((m_t.double() - m_64).abs().max()),
            "K2 - plain": float((m_k - m_p).abs().max())}


def k2_roundoff_phase(dev, seed: int) -> None:
    """4b. K2's mask on full-scale noise (8 x 40 blocks, far end at unit
    variance, Kalman residual as stage 2's input) through four untrained
    nets, against the fp64 evaluation and the plain version, where the
    mask's round-off is largest; the plain fp32 version and TF32 products
    (the lower-precision control) beside it."""
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels.kalman import kalman_cancel_plain
    from aec_tpu_torch.models.little_net import little_net_init

    erb = torch.as_tensor(erb_filterbank(), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 40 * HOP
    with torch.no_grad():
        for s in range(1, 5):
            rnet = little_net_init(generator=torch.Generator().manual_seed(seed + s), device=dev)
            far = torch.randn(8, n, generator=g, device=dev)
            rir = torch.randn(8, 300, generator=g, device=dev)
            rir = 0.3 * rir * torch.exp(-torch.arange(300, device=dev) / 60.0)
            echo = torch.fft.irfft(torch.fft.rfft(far, n + 300) * torch.fft.rfft(rir, n + 300),
                                   n + 300)[:, :n]
            mic = echo + 0.01 * torch.randn(8, n, generator=g, device=dev)
            lin = kalman_cancel_plain(KalmanConfig(), far, mic)["wav"]
            r = k2_against_fp64(rnet, lin.reshape(8, -1, HOP), far.reshape(8, -1, HOP), erb)
            phase("K2 round-off", f"untrained net {seed + s}, full-scale noise: mask max|d| from "
                  f"fp64: K2 {r['K2']:.3e}, plain fp32 {r['plain']:.3e}, TF32 products "
                  f"{r['tf32']:.3e} (control, >= {K2_CONTROL_MIN:g}); K2 - plain "
                  f"{r['K2 - plain']:.3e} (bar {K2_LOUD_MASK_TOL:g} for K2 - fp64 and K2 - plain)")
            check(max(r["K2"], r["K2 - plain"]) <= K2_LOUD_MASK_TOL,
                  "K2's mask is off its fp64 evaluation or its plain version")
            check(r["tf32"] >= K2_CONTROL_MIN, "the TF32 control sits within the mask bar")


def lstm_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """22. K9 at DccrnConfig()'s width (two groups, I = H = 1024, T = 513)
    at B = 1 and B = 8 against its plain version; times beside the plain
    scan and cuDNN's nn.LSTM (one call per group over the 2B rows with K9's
    weights; it also does the input projection K9 leaves to a matmul)."""
    from aec_tpu_torch.kernels.lstm import (
        grouped_lstm_recurrence,
        grouped_lstm_recurrence_plain,
        grouped_projection,
        stacked,
    )
    from aec_tpu_torch.ops.lstm import complex_lstm_init

    g = torch.Generator().manual_seed(seed)
    out = {"err": 0.0, "shapes": {}}
    for b in (1, 8):
        params = complex_lstm_init(2048, 2048, generator=g, device=dev)
        r, i = (torch.randn(b, T_DCCRN, 1024, generator=g).to(dev) for _ in range(2))
        x2 = torch.cat([r, i], 0)
        lstms = []
        for grp in ("real", "imag"):
            lstm = torch.nn.LSTM(1024, 1024, batch_first=True).to(dev)
            with torch.no_grad():
                for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(lstm, name).copy_(params[grp][key])
            lstms.append(lstm)
        with torch.no_grad():
            xp = grouped_projection(params, x2).contiguous()
            w = stacked(params, "w_hh")
            ys = grouped_lstm_recurrence(xp, w)
            want = grouped_lstm_recurrence_plain(xp, w)
            lib = torch.stack([m(x2)[0] for m in lstms])
            torch.cuda.synchronize()
            check(ys.shape == (2, 2 * b, T_DCCRN, 1024) and bool(torch.isfinite(ys).all()),
                  "K9 output")
            err = float((ys - want).abs().max())
            lib_err = float((lib - want).abs().max())
            t_k = time_ms(lambda: grouped_lstm_recurrence(xp, w), reps)
            t_p = time_ms(lambda: grouped_lstm_recurrence_plain(xp, w), reps)
            t_lib = time_ms(lambda: [m(x2) for m in lstms], reps)
        phase("K9 vs plain", f"B = {b}, T = {T_DCCRN}, H = 1024, 2 groups: max|d| = {err:.3e} "
              f"(bar {K9_TOL:g}); cuDNN nn.LSTM vs plain {lib_err:.3e} (information)")
        check(err <= K9_TOL, "K9 disagrees with its plain version")
        phase("time", f"K9 B = {b}, T = {T_DCCRN}: {t_k:.3f} ms (plain {t_p:.2f} ms, cuDNN "
              f"nn.LSTM x 2 groups {t_lib:.3f} ms) [{smi}]")
        out["err"] = max(out["err"], err)
        out["shapes"][b] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_lib}
        del params, xp, w, ys, want, lib, lstms
    return out


def dccrn_phase(dev, names, s_far, s_mic, reps: int, smi: str) -> dict:
    """23. cli/infer's DCCRN enhancer: DccrnConfig() from dccrn_init (seed
    0), saved with train/checkpoints.save under {params, model_state} and
    restored by _make_enhancer("dccrn", path, "kalman"), on the 8 scenes one
    by one (batch 1, as cli/infer's loader gives them). The kernel route
    runs K1 once and K9 twice (one launch per complex-LSTM layer) per
    utterance; its plain version is the same path with Kalman's plain loop
    and the plain complex-LSTM scan, on the card."""
    from aec_tpu_torch.cli.infer import _make_enhancer, _tree_to
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_apply, dccrn_init
    from aec_tpu_torch.train import checkpoints

    params, state = dccrn_init(generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dccrn.npz")
        checkpoints.save(path, {"params": params, "model_state": state})
        enhance, params = _make_enhancer("dccrn", path, "kalman", StftConfig(), device=dev)
    state = _tree_to(state, dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def kernel_route():
        return [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))]

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        out, _ = dccrn_apply(params, state, lin, sf[i:i + 1], DccrnConfig(), lstm_fused=False)
        return out["wav"]

    got, (k1, k9) = drive((kalman_cancel_fused_batched, grouped_lstm_recurrence), kernel_route)
    phase("dccrn path", f"cli/infer DCCRN enhancer, 8 scenes x {N} one by one: launches K1 {k1}, "
          f"K9 {k9} (cuDNN TF32 {torch.backends.cudnn.allow_tf32})")
    check(k1 == len(names) and k9 == 2 * len(names),
          "the DCCRN path did not run K1 + K9 per utterance")
    worst = 0.0
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == (1, N) and bool(torch.isfinite(got[i]).all()), "DCCRN wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_plain = time_ms(lambda: plain_route(0), max(1, reps // 2))
    phase("dccrn path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{DCCRN_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms) [{smi}]")
    check(worst <= DCCRN_WAV_TOL, "the DCCRN kernel route disagrees with its plain route")
    print(f"dccrn_utt_ms={t_utt:.3f}", flush=True)
    return {"k9_launches": k9}


def fullsubnet_phase(dev, names, s_far, s_mic, reps: int, smi: str) -> dict:
    """24. K11 at FullSubNetConfig()'s widths (H_fb 256, H_sb 96, F = 161) over
    T = 820 frames (8.2 s at hop 160) at B = 1 and 4 against its plain joint
    loop, timed beside it; cli/infer's FullSubNet enhancer (fullsubnet_init,
    seed 0, saved with train/checkpoints, restored by
    _make_enhancer("fullsubnet", path, "kalman")) on the 8 scenes one by one,
    K1 + K11 per utterance, against the plain route (Kalman's plain loop, the
    plain joint loop) on the card."""
    from aec_tpu_torch.cli.infer import _make_enhancer
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.models.fullsubnet import (
        FullSubNetConfig,
        _joint_scan_hs,
        fullsubnet_apply,
        fullsubnet_init,
    )
    from aec_tpu_torch.train import checkpoints

    cfg = FullSubNetConfig()
    g = torch.Generator().manual_seed(0)
    out = {"err": 0.0, "shapes": {}}
    for b in (1, 4):
        params = fullsubnet_init(cfg, generator=g, device=dev)
        xp_fb = (0.3 * torch.randn(b, T_FSN, 4 * cfg.fb_hidden, generator=g)).to(dev)
        xp_sb = (0.3 * torch.randn(b, T_FSN, cfg.n_freqs, 4 * cfg.sb_hidden, generator=g)).to(dev)
        with torch.no_grad():
            ys = joint_recurrence(params, xp_fb, xp_sb)
            want = _joint_scan_hs(params, xp_fb, xp_sb)
            torch.cuda.synchronize()
            check(ys.shape == (b, T_FSN, cfg.n_freqs, cfg.sb_hidden)
                  and bool(torch.isfinite(ys).all()), "K11 output")
            err = float((ys - want).abs().max())
            t_k = time_ms(lambda: joint_recurrence(params, xp_fb, xp_sb), reps)
            t_p = time_ms(lambda: _joint_scan_hs(params, xp_fb, xp_sb), 1)
        phase("K11 vs plain", f"B = {b}, T = {T_FSN}, H_fb 256, H_sb 96, F 161: max|d| = "
              f"{err:.3e} (bar {K11_TOL:g})")
        check(err <= K11_TOL, "K11 disagrees with its plain version")
        phase("time", f"K11 B = {b}, T = {T_FSN}: {t_k:.3f} ms (plain joint loop {t_p:.2f} ms) "
              f"[{smi}]")
        out["err"] = max(out["err"], err)
        out["shapes"][b] = {"ms": t_k, "plain_ms": t_p}
        del params, xp_fb, xp_sb, ys, want

    params = fullsubnet_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fullsubnet.npz")
        checkpoints.save(path, {"params": params})
        enhance, params = _make_enhancer("fullsubnet", path, "kalman", StftConfig(), device=dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        return fullsubnet_apply(params, lin, sf[i:i + 1], cfg, joint_kernel=False)["wav"]

    got, (k1, k11) = drive((kalman_cancel_fused_batched, joint_recurrence),
                           lambda: [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))])
    phase("fullsubnet path", f"cli/infer FullSubNet enhancer, 8 scenes x {N} one by one: "
          f"launches K1 {k1}, K11 {k11}")
    check(k1 == len(names) and k11 == len(names),
          "the FullSubNet path did not run K1 + K11 per utterance")
    worst = 0.0
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == want.shape and bool(torch.isfinite(got[i]).all()),
                  "FullSubNet wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_plain = time_ms(lambda: plain_route(0), 1)
    phase("fullsubnet path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{ENHANCER_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms) [{smi}]")
    check(worst <= ENHANCER_WAV_TOL, "the FullSubNet kernel route disagrees with its plain route")
    out["launches"] = k11
    return out


def att_ccrn_phase(dev, names, s_far, s_mic, reps: int, smi: str) -> dict:
    """25. K10 at ATT-CCRN's bottleneck (H = 4096, T = 513, B = 1) against the
    plain int8 loop, with the count of h's codes that differ, timed beside it
    (the plain loop once: its float64 product streams 537 MB a step) and,
    for information, the f32 plain loop; cli/infer's ATT-CCRN enhancer
    (att_ccrn_init, seed 0; --lstm_dtype auto, int8 on the card) on the 8
    scenes, K1 + K10 per utterance, against the plain route (Kalman's plain
    loop, the plain int8 loop), and its wav SNR against the f32 route."""
    from aec_tpu_torch.cli.infer import _make_enhancer, _tree_to
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence
    from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply, att_ccrn_init
    from aec_tpu_torch.ops.lstm import (
        lstm_init,
        lstm_int8_recurrence_plain,
        lstm_scan,
        quantize_rows_int8,
    )
    from aec_tpu_torch.train import checkpoints

    h = 4096
    g = torch.Generator().manual_seed(0)
    lp = lstm_init(h, h, generator=g, device=dev)
    x = torch.randn(1, T_DCCRN, h, generator=g).to(dev)
    with torch.no_grad():
        xp = x @ lp["w_ih"].T + lp["b_ih"]
        w_q, w_scale = quantize_rows_int8(lp["w_hh"])
        args = (xp, w_q, w_scale / 127.0, lp["b_hh"], torch.zeros(1, h, device=dev),
                torch.zeros(1, h, device=dev))
        ys, (_, c_t) = lstm_int8_recurrence(*args)
        want, (_, c_w) = lstm_int8_recurrence_plain(*args)
        torch.cuda.synchronize()
        check(ys.shape == (1, T_DCCRN, h) and bool(torch.isfinite(ys).all()), "K10 output")
        err = max(float((ys - want).abs().max()), float((c_t - c_w).abs().max()))
        code = lambda y: torch.round(torch.clamp(y * 127.0, -127.0, 127.0))  # noqa: E731
        flips = int((code(ys) != code(want)).sum())
        t_k = time_ms(lambda: lstm_int8_recurrence(*args), reps)
        t_p = time_once(lambda: lstm_int8_recurrence_plain(*args))
        lstm_scan(lp, x[:, :8])  # warm the f32 loop's kernels
        t_f32 = time_once(lambda: lstm_scan(lp, x))
    phase("K10 vs plain", f"B = 1, T = {T_DCCRN}, H = {h}: max|d| = {err:.3e} (bar {K10_TOL:g}); "
          f"codes of h that differ: {flips} of {ys.numel()}")
    check(err <= K10_TOL, "K10 disagrees with its plain version")
    phase("time", f"K10 B = 1, T = {T_DCCRN}, H = {h}: {t_k:.3f} ms (plain int8 loop {t_p:.2f} ms "
          f"once; f32 plain loop {t_f32:.2f} ms, information; the per-step restream of 67 MB "
          f"of codes from HBM alone: {T_DCCRN * 4 * h * h / PEAK_HBM * 1e3:.2f} ms) [{smi}]")
    out = {"err": err, "flips": flips, "ms": t_k, "plain_ms": t_p}
    del lp, x, xp, w_q, args, ys, want

    cfg = AttCcrnConfig()
    params, state = att_ccrn_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "att_ccrn.npz")
        checkpoints.save(path, {"params": params, "model_state": state})
        enhance, params = _make_enhancer("att_ccrn", path, "kalman", StftConfig(), device=dev)
        enhance_f32, _ = _make_enhancer("att_ccrn", path, "kalman", StftConfig(),
                                        lstm_dtype="f32", device=dev)
    state = _tree_to(state, dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        return att_ccrn_apply(params, state, lin, sf[i:i + 1], cfg, lstm_recurrent_dtype="int8",
                              lstm_int8_kernel=False)[0]["wav"]

    got, (k1, k10) = drive((kalman_cancel_fused_batched, lstm_int8_recurrence),
                           lambda: [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))])
    phase("att_ccrn path", f"cli/infer ATT-CCRN enhancer (--lstm_dtype auto), 8 scenes x {N} one "
          f"by one: launches K1 {k1}, K10 {k10}")
    check(k1 == len(names) and k10 == len(names),
          "the ATT-CCRN path did not run K1 + K10 per utterance")
    worst, snrs = 0.0, []
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == want.shape and bool(torch.isfinite(got[i]).all()),
                  "ATT-CCRN wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
            ref = enhance_f32(sf[i:i + 1], sm[i:i + 1])
            noise = float(((got[i] - ref) ** 2).sum())
            snrs.append(10 * np.log10(float((ref ** 2).sum()) / noise) if noise else np.inf)
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_plain = time_once(lambda: plain_route(0))
        t_f32 = time_ms(lambda: enhance_f32(sf[:1], sm[:1]), 1)
    phase("att_ccrn path", "int8 route vs f32 route, wav SNR dB: " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(names, snrs)) + f" (bar >= {INT8_SNR_MIN_DB:g})")
    phase("att_ccrn path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{ENHANCER_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms once; f32 route "
          f"{t_f32:.1f} ms) [{smi}]")
    check(worst <= ENHANCER_WAV_TOL, "the ATT-CCRN kernel route disagrees with its plain route")
    check(min(snrs) >= INT8_SNR_MIN_DB, "the ATT-CCRN int8 route is off its f32 route")
    out["launches"] = k10
    return out


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
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
        single_stream_lib,
    )
    from aec_tpu_torch.linear import overlap_save as ols
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
                        "single_stream", "gru", "lstm", "fullsubnet", "lstm_int8")
    build_s = time.perf_counter() - t0
    phase("build", f"{build_s:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                phase("build", f"{src}: {line.strip()}")

    cfg = KalmanConfig()
    net = load_npz("checkpoints/little_net_robust.npz", device=dev)
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
        del o_k, o_p, m_k, m_p
        r = k2_against_fp64(net, lin_b, far_b, erb)
        phase("K2 round-off", f"main path: mask max|d| from fp64: K2 {r['K2']:.3e} (bar "
              f"{K2_MASK_TOL:g}), plain fp32 {r['plain']:.3e}, TF32 products {r['tf32']:.3e} "
              f"(control, >= {K2_CONTROL_MIN:g})")
        check(r["K2"] <= K2_MASK_TOL, "K2's mask is off its fp64 evaluation")
        check(r["tf32"] >= K2_CONTROL_MIN, "the TF32 control sits within the mask bar")
    del e_k, e_p
    k2_roundoff_phase(dev, args.seed)

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
    plain_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz", device="cpu"),
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
    nl_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz", device="cpu"),
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

    t_main = N // HOP
    # 16-18. K8 against its plain version and cuDNN; its gradients; the trainer
    gru = gru_phase(dev, args.seed, args.reps, smi)
    trained = trainer_phase(dev, args.seed, args.reps, smi)

    # 19. the wide-net single-utterance route: the width-4 checkpoint on the 8
    #     scenes one by one (stage 1 on K6, stage 2 offline with its GRU on
    #     K8 at H = 128) against the CPU route
    from aec_tpu_torch.kernels.gru import gru_recurrence

    w4_path = "checkpoints/little_net_dtalk_w4.npz"
    w4 = load_npz(w4_path, device=dev)
    with torch.no_grad():
        w4_out, (k6_w4, k8_w4) = drive(
            (kalman_cancel_fused, gru_recurrence),
            lambda: [two_stage_cancel(w4, sf[i], sm[i], erb) for i in range(len(names))])
    w4_ref = two_stage_cancel(load_npz(w4_path, device="cpu"), torch.from_numpy(s_far),
                              torch.from_numpy(s_mic), erb_filterbank())
    w4_worst = 0.0
    for i, k in enumerate(names):
        got = [erle_tail(s_mic[i], w4_out[i][key].cpu().numpy()) for key in ("linear_wav", "wav")]
        want = [erle_tail(s_mic[i], w4_ref[key][i].numpy()) for key in ("linear_wav", "wav")]
        check(all(np.isfinite(got)), f"width-4 route ERLE on {k}")
        w4_worst = max(w4_worst, *(abs(a - b) for a, b in zip(got, want)))
        phase("wide net", f"{k:13s} stage 1 {got[0]:8.3f} / {want[0]:8.3f}, two-stage "
              f"{got[1]:8.3f} / {want[1]:8.3f} (card / CPU route)")
    with torch.no_grad():
        t_w4 = time_ms(lambda: two_stage_cancel(w4, sf[0], sm[0], erb), args.reps)
    phase("wide net", f"little_net_dtalk_w4 one by one, 8 x {N}: launches K6 {k6_w4}, K8 {k8_w4}; "
          f"worst |card - CPU| tail ERLE {w4_worst:.4f} dB (bar {ERLE_TOL_DB} dB); "
          f"{t_w4:.2f} ms per utterance [{smi}]")
    check(k6_w4 > 0 and k8_w4 > 0, "the wide-net route did not go through K6 and K8")
    check(w4_worst <= ERLE_TOL_DB, "the wide-net route disagrees with the CPU route")

    # 20. K12: the spectra-in entry at the main shape against K1 (the same
    #     step, analysis in the kernel) and its plain loop; then times, in
    #     turns with K1 (K1, K12, K12, K1)
    x_ri = ols.far_end_spectra(far, HOP).contiguous()
    d_blocks = mic.reshape(BATCH, -1, HOP)
    with torch.no_grad():
        e12, (k12_launches,) = drive((kalman_filter_fused_batched,),
                                     lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks))
        e1 = kalman_cancel_fused_batched(cfg, far, mic)["wav"].reshape(BATCH, -1, HOP)
        ep = kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks)
        torch.cuda.synchronize()
        k12_err = float((e12 - ep).abs().max())
        k12_k1 = float((e12 - e1).abs().max())
        check(e12.shape == d_blocks.shape and bool(torch.isfinite(e12).all()), "K12 output")
        phase("K12", f"{BATCH} x {t_main} blocks: launches {k12_launches}; max|d| vs K1 "
              f"{k12_k1:.3e}, vs plain {k12_err:.3e} (bar {K1_TOL:g} x max|mic| = "
              f"{K1_TOL * mic_scale:.3e})")
        check(k12_launches == 1 and max(k12_err, k12_k1) <= K1_TOL * mic_scale,
              "K12 disagrees with K1 or its plain version")
        k12_turns = [time_ms(lambda: fn(), args.reps) for fn in (
            lambda: kalman_cancel_fused_batched(cfg, far, mic),
            lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks),
            lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks),
            lambda: kalman_cancel_fused_batched(cfg, far, mic))]
        t_k12 = statistics.median(k12_turns[1:3])
        t_p12 = time_ms(lambda: kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks), args.reps)
    phase("time", f"K12 {BATCH} x {N}: {t_k12:.2f} ms (plain {t_p12:.2f} ms); in turns K1 / K12 / "
          f"K12 / K1: {' / '.join(f'{t:.2f}' for t in k12_turns)} ms [{smi}]")
    del x_ri, d_blocks, e12, e1, ep

    # 21. the stage-1/2 kernels at other geometries and at their largest
    #     partition counts; 22-23. K9 and the DCCRN path
    geometry_phase(dev, net, names, s_far, s_mic, smi)
    limits_phase(dev, net, args.seed, smi)
    lstm = lstm_phase(dev, args.seed, args.reps, smi)
    dccrn = dccrn_phase(dev, names, s_far, s_mic, args.reps, smi)
    # 24-25. K11 and the FullSubNet path; K10 and the ATT-CCRN path
    fsn = fullsubnet_phase(dev, names, s_far, s_mic, args.reps, smi)
    att = att_ccrn_phase(dev, names, s_far, s_mic, args.reps, smi)

    # 26. the kernels of the paths, with this run's numbers; bounds from
    #     this run's shapes (module top); library_ms where one PyTorch call
    #     computes the same function (cuDNN's GRU for K8, its LSTM for K9),
    #     else null (no PyTorch call computes K10's int8 recurrence or
    #     K11's coupled full-band / sub-band recurrence)
    t_utt = -(-N_UTT // HOP)
    state_bytes = {k: 4 * sum(v.numel() for v in st.values()) // S_SERVE
                   for k, st in (("kalman", ks), ("nlms", ks_n))}
    serve_io = 3 * S_SERVE * HOP * 4 + STAGE1_BASES + STAGE2_BASES
    stage1_batch = bound(BATCH * t_main * STAGE1_FMA, 3 * BATCH * N * 4 + STAGE1_BASES)
    stage1_one = bound(t_utt * STAGE1_FMA, 3 * N_UTT * 4 + STAGE1_BASES)
    masks = BATCH * (t_main + 1) * BANDS * 4
    k8 = gru["shapes"][(1, 1001, BANDS)]
    k9 = lstm["shapes"][1]
    # K9 per layer at B = 1: 2 groups x 2 rows x 4H x H FMA per frame; xp in,
    # W_hh read, ys out
    k9_bound = bound(2 * 2 * 4 * 1024 * 1024 * T_DCCRN,
                     4 * (2 * 2 * T_DCCRN * 4 * 1024 + 2 * 4 * 1024 * 1024
                          + 2 * 2 * T_DCCRN * 1024))
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
        # K8 at one 16 s utterance, H = 32; launches from the trainer's validation
        ("gru_scan", "gru.cu", "pallas_gru.py:65", trained["k8_val"], gru["err"], k8["ms"],
         k8["plain_ms"], gru_bound(1, 1001, BANDS)),
        ("kalman_batched_spectra", "kalman_batched.cu", "pallas_kalman.py:303", k12_launches,
         k12_err, t_k12, t_p12,
         bound(BATCH * t_main * (STAGE1_FMA - FRAME * RI),
               4 * BATCH * t_main * (RI + 2 * HOP) + STAGE1_BASES)),
        # K9 at one 8.2 s utterance (B = 1, T = 513); launches from the DCCRN path
        ("lstm_grouped", "lstm.cu", "pallas_lstm.py:88", dccrn["k9_launches"], lstm["err"],
         k9["ms"], k9["plain_ms"], k9_bound),
        # K10 at ATT-CCRN's bottleneck (B = 1, T = 513, H = 4096); launches from its path
        ("lstm_int8", "lstm_int8.cu", "pallas_lstm.py:237", att["launches"], att["err"],
         att["ms"], att["plain_ms"], int8_bound(1, T_DCCRN, 4096)),
        # K11 at one 8.2 s utterance (B = 1, T = 820); launches from the FullSubNet path
        ("fullsubnet_joint", "fullsubnet.cu", "pallas_fullsubnet.py:106", fsn["launches"],
         fsn["err"], fsn["shapes"][1]["ms"], fsn["shapes"][1]["plain_ms"], fsn_bound(1, T_FSN)),
    ]
    # cuDNN's nn.GRU and nn.LSTM with the kernels' weights
    library_ms = {"gru_scan": k8["library_ms"], "lstm_grouped": k9["library_ms"]}
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"aec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"aec_tpu/kernels/{tpu}", "launches": n, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, **bnd, "library_ms": library_ms.get(kernel)}
        for kernel, src, tpu, n, err, ms, plain_ms, bnd in rows
    ]}), flush=True)
    # 27. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
