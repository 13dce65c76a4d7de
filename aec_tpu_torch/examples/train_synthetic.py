"""Train the stage-2 LittleNet post-filter on synthetic echo scenes, the
port's ``examples/train_synthetic.py``: the recipe of every shipped stage-2
checkpoint (``checkpoints/little_net_robust.npz`` among them).

  python -m aec_tpu_torch.examples.train_synthetic [--steps 1500] [--batch 64] \
      [--out checkpoints/little_net_robust.npz] [--device cpu]

Scenes are AEC-Challenge-style: far-end speech-shaped noise OR harmonic
speech-like excitation (drifting pitch, syllabic envelope) through a random
decaying RIR with random bulk delay (0-40 ms) and, on a fraction of scenes,
memoryless loudspeaker saturation (tanh soft clip), plus near-end speech
(harmonic or shaped noise) at random SNR. The net trains on the two-stage
configuration it is deployed in: its mic input is the stage-1 Kalman
canceller's output, its reference the far end.

Every step runs on the card unless ``--device cpu`` is passed: the scenes
are drawn there from a ``torch.Generator`` (:func:`scene_draws`) and made
there with ``torch.fft`` (:func:`synthesize_scenes`), stage 1 runs as kernel
K1 on the batch, LittleNet's GRU as K8 forward and K8b backward, then
optax's clipped Adam with a cosine schedule (``train/loop.Optimizer``). The
flags are the JAX script's, plus ``--device``. The checkpoint is an
``.npz`` in the JAX package's format with the JAX script's ``.json`` keys.
The nets differ from JAX's for one seed: the port draws from
``torch.Generator``, JAX from ``jax.random`` keys.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from aec_tpu_torch.configs import KalmanConfig, TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.models.little_net import little_net_apply, little_net_init, little_net_loss
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.train.loop import Optimizer, cosine_decay_schedule, make_train_step
from aec_tpu_torch.train.metrics import erle, si_snr_rows
from aec_tpu_torch.utils.weights import params_to_jax

SR = 16000
RIR_LEN = 1600
MAX_DELAY = 640  # up to 40 ms of bulk delay in the echo path
EVAL_SCENES, EVAL_SEED = 16, 123


def scene_draws(generator: torch.Generator, b: int, n: int,
                rir_len: int = RIR_LEN) -> dict:
    """Every random number :func:`synthesize_scenes` needs for ``b`` scenes
    of ``n`` samples, drawn on ``generator``'s device: uniforms in [0, 1),
    standard normals, and the bulk delays as integers in [0, MAX_DELAY).

    One draw set per role (``"far"``, ``"near"``), as JAX draws both of a
    role's excitations from one key: ``white`` and ``env`` the shaped
    noise's, ``f0``, ``harmonics``, ``syllable`` and ``noise`` the harmonic
    signal's. JAX's key reuse is reproduced where its numbers are tied: two
    uniforms of one shape from one key are one ``u`` scaled twice, so
    ``env`` gives the shaped noise's envelope rate and phase, ``f0`` the
    pitch and its drift's phase, and ``syllable`` the syllabic envelope's
    rate and phase. Two ties of JAX's are not reproduced, and are drawn
    independently here: ``k_rir``'s (b, 1) uniform (``decay``) and (b, L)
    normal (``rir``) share random bits only through the key's counter
    layout; and under partitionable threefry (JAX >= 0.5) a role's ``env``
    and ``f0`` come from one key (``split(k)[0] == split(k, 4)[0]``), which
    no output shows: a scene takes one of its role's two excitations."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def z(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def role():
        return {"white": z(b, n), "env": u(b, 1), "f0": u(b, 1), "harmonics": u(b, 6),
                "syllable": u(b, 1), "noise": z(b, n)}

    return {
        "far": role(), "near": role(), "kind": u(b, 1), "near_kind": u(b, 1),
        "active": u(b, 1), "tilt": u(b, 1), "decay": u(b, 1), "rir": z(b, rir_len + MAX_DELAY),
        "delay": torch.randint(0, MAX_DELAY, (b, 1), generator=generator, device=dev),
        "gain": u(b, 1), "nonlinear": u(b, 1), "snr": u(b, 1),
    }


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s scaling of its [0, 1) draw ``u`` to [lo, hi)
    in float32: ``u * (hi - lo) + lo``, at least ``lo``."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(u * float(hi32 - lo32) + float(lo32), float(lo32))


def _peak_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.amax(torch.abs(x), dim=-1, keepdim=True) + 1e-9)


def _cumsum_blocked(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Cumulative sum over the last axis in the order XLA's CPU backend sums
    ``jnp.cumsum``: sequential runs of ``base``, the runs' totals scanned the
    same way and added back. The pitch track's phase sums ~1e4-1e5 samples
    of ~100-250 in float32, where a sequential sum drifts ~1e-4 rad from this
    order at 8,192 samples (1e-3 at 64,000) and the harmonics multiply it."""
    n = x.shape[-1]

    def seq(y):
        out = [y[..., 0]]
        for i in range(1, y.shape[-1]):
            out.append(out[-1] + y[..., i])
        return torch.stack(out, dim=-1)

    if n <= base:
        return seq(x)
    m = -(-n // base) * base
    runs = seq(F.pad(x, (0, m - n)).reshape(*x.shape[:-1], m // base, base))
    carry = F.pad(_cumsum_blocked(runs[..., -1], base), (1, 0))[..., :-1]
    return (runs + carry[..., None]).reshape(*x.shape[:-1], m)[..., :n]


def _rfftfreq(n: int, sr: int, device) -> torch.Tensor:
    """``jnp.fft.rfftfreq(n, 1 / sr)`` in float32: ``k / float32(n / sr)``."""
    return torch.arange(n // 2 + 1, dtype=torch.float32, device=device) / float(
        np.float32(1.0 / sr * n))


def _speech_shaped(d: dict, n: int, sr: int) -> torch.Tensor:
    """Tilted white noise under a half-wave syllabic envelope."""
    f = _rfftfreq(n, sr, d["white"].device)
    tilt = 1.0 / torch.clamp_min(f / 500.0, 1.0)
    shaped = torch.fft.irfft(torch.fft.rfft(d["white"]) * tilt, n=n)
    rate, phase = _uniform(d["env"], 2.0, 6.0), _uniform(d["env"], 0.0, 2 * math.pi)
    t = torch.arange(n, dtype=torch.float32, device=f.device)
    env = 0.5 + 0.5 * torch.clamp_min(torch.sin(2 * math.pi * rate * t / sr + phase), 0.0)
    return _peak_normalize(shaped * env)


def _harmonic_speech(d: dict, n: int, sr: int) -> torch.Tensor:
    """A drifting-pitch harmonic stack under a syllabic envelope with pauses
    (``benchmarks/scenes.py::speech_like`` on tensors)."""
    t = (torch.arange(n, dtype=torch.float32, device=d["f0"].device) / sr)[None, :]
    f0 = _uniform(d["f0"], 90.0, 230.0)
    drift = 1.0 + 0.08 * torch.sin(2 * math.pi * 0.7 * t + _uniform(d["f0"], 0.0, 6.28))
    ph = 2 * math.pi * _cumsum_blocked(f0 * drift) / sr
    phases = _uniform(d["harmonics"], 0.0, 6.28)
    sig = torch.zeros_like(ph)
    for k, a in enumerate((1.0, 0.6, 0.45, 0.3, 0.2, 0.12)):
        sig = sig + a * torch.sin((k + 1) * ph + phases[:, k : k + 1])
    rate = _uniform(d["syllable"], 2.5, 4.5)
    env = torch.clamp_min(torch.sin(2 * math.pi * rate * t + _uniform(d["syllable"], 0.0, 6.28))
                          + 0.25, 0.0) ** 1.5
    return _peak_normalize(sig * env + 0.02 * d["noise"])


def synthesize_scenes(draws: dict, n: int, sr: int = SR):
    """``(far, mic, near)``, each (b, n), from :func:`scene_draws`' numbers
    on their device: deterministic, the arithmetic of JAX's ``make_scene_fn``
    in its order. Half the far ends harmonic speech, half shaped noise; the
    near end half harmonic, half shaped noise under a random spectral
    emphasis, silent in ~30 % of scenes; the echo the far end (soft-clipped
    in ~30 %) through a decaying RIR with a bulk delay, by a zero-padded FFT
    convolution of length ``n + L``; ``mic`` and ``near`` scaled together
    so that ``mic`` peaks at 1.

    The harmonic excitations' pitch phase is a float32 running sum of
    ~1e4-1e5 increments: one ulp of difference in a ``sin`` flips later
    roundings of the sum, and the phase moves ~1e-3 rad. So those scenes
    agree with JAX's to ~1e-3 of their scale (JAX's jitted and eager
    evaluations of its own function differ as much: under ``jit`` XLA folds
    ``2 pi x / sr`` into one product), every other scene to float32
    round-off."""
    def pick(u, p, a, b_):
        w = (u < p).to(torch.float32)
        return w * a + (1.0 - w) * b_

    far = pick(draws["kind"], 0.5, _harmonic_speech(draws["far"], n, sr),
               _speech_shaped(draws["far"], n, sr))
    near_sn = _speech_shaped(draws["near"], n, sr)
    f = _rfftfreq(n, sr, far.device)
    center = _uniform(draws["tilt"], 300.0, 3000.0)
    emphasis = torch.exp(-((torch.log(f[None, :] + 30.0) - torch.log(center)) ** 2))
    near_sn = torch.fft.irfft(torch.fft.rfft(near_sn) * emphasis, n=n)
    near = _peak_normalize(pick(draws["near_kind"], 0.5, _harmonic_speech(draws["near"], n, sr),
                                near_sn))
    active = (draws["active"] < 0.7).to(torch.float32)

    rir = draws["rir"]
    length = rir.shape[-1]
    decay = _uniform(draws["decay"], 100.0, 500.0)
    delay = draws["delay"].to(torch.float32)
    idx = torch.arange(length, dtype=torch.float32, device=far.device)[None, :]
    rir = _peak_normalize(rir * torch.exp(-torch.clamp_min(idx - delay, 0.0) / decay)
                          * (idx >= delay))
    gain = _uniform(draws["gain"], 0.3, 1.0)
    far_ls = pick(draws["nonlinear"], 0.3, torch.tanh(2.5 * far) / 2.5, far)
    m = n + length
    echo = torch.fft.irfft(torch.fft.rfft(far_ls, n=m) * torch.fft.rfft(gain * rir, n=m),
                           n=m)[:, :n]
    near = active * _uniform(draws["snr"], 0.2, 0.8) * near
    mic = echo + near
    scale = 1.0 / (torch.amax(torch.abs(mic), dim=-1, keepdim=True) + 1e-9)
    return far, mic * scale, near * scale


def linear_output(kcfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor,
                  scfg: StftConfig = StftConfig()) -> torch.Tensor:
    """Stage 1 on the batch, outside autograd: K1 on a CUDA tensor."""
    with torch.no_grad():
        return kalman_cancel(kcfg, far, mic, block=scfg.hop)["wav"]


def recipe_loss(balance: bool = False, asym: float = 0.0, sisnr: float = 0.0):
    """The script's objective as a ``train/loop.make_train_step`` loss:
    ``loss_fn(net, lin, far, near, erb, scfg, sqrt_eps=) -> (loss, aux)``.

    ``balance``: each scene's loss (``normalize=False``) divided by its own
    value outside autograd, then their mean, from ONE batched forward (K8 at
    the whole batch) where JAX maps a batch-1 loss over the scenes; no term
    mixes scenes there (``little_net_loss(per_scene=True)``). Otherwise the
    batch's loss with ``asym`` and ``sisnr`` (which implies ``gain_norm``)."""
    def loss_fn(net, lin, far, near, erb, scfg, *, sqrt_eps):
        if balance:
            li, aux = little_net_loss(net, lin, far, near, erb, scfg, normalize=False,
                                      sqrt_eps=sqrt_eps, asym_weight=asym, per_scene=True)
            return torch.mean(li / (li.detach() + 1e-2)), aux
        return little_net_loss(net, lin, far, near, erb, scfg, sqrt_eps=sqrt_eps,
                               asym_weight=asym, sisnr_weight=sisnr, gain_norm=sisnr > 0)

    return loss_fn


def recipe_optimizer(net, lr: float, steps: int) -> Optimizer:
    """``optax.chain(clip_by_global_norm(5.0), adam(cosine_decay_schedule(lr,
    steps, 0.05)))`` over ``net``'s parameters."""
    return Optimizer(TrainConfig(lr=lr, clip_norm=5.0), 1, net,
                     schedule=cosine_decay_schedule(lr, steps, 0.05))


def _sisnr_active(est: torch.Tensor, near: torch.Tensor, half: int) -> torch.Tensor:
    """Mean per-scene SI-SNR of the second halves over scenes whose near end
    is active."""
    per = si_snr_rows(est[:, half:], near[:, half:])
    act = (torch.mean(near * near, dim=-1) > 1e-8).to(torch.float32)
    return torch.sum(per * act) / torch.clamp_min(torch.sum(act), 1.0)


@torch.no_grad()
def eval_metrics(net, far, mic, near, erb, kcfg: KalmanConfig = KalmanConfig(),
                 scfg: StftConfig = StftConfig()) -> tuple[torch.Tensor, ...]:
    """(echo-only ERLE of stage 1, of both stages, double-talk SI-SNR of the
    linear output, of the enhanced one), dB over each scene's second half:
    stage 1 (K1) and ``little_net_apply`` (K8) on the scenes and on their
    echo-only variant (``mic - near``)."""
    half = far.shape[-1] // 2
    lin = kalman_cancel(kcfg, far, mic, block=scfg.hop)["wav"]
    enh = little_net_apply(net, lin, far, erb, scfg)["wav"]
    mic_e = mic - near
    lin_e = kalman_cancel(kcfg, far, mic_e, block=scfg.hop)["wav"]
    enh_e = little_net_apply(net, lin_e, far, erb, scfg)["wav"]
    return (erle(mic_e[:, half:], lin_e[:, half:]), erle(mic_e[:, half:], enh_e[:, half:]),
            _sisnr_active(lin, near, half), _sisnr_active(enh, near, half))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--out", type=str, default="checkpoints/little_net_robust.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--balance", action="store_true",
                   help="per-scene self-normalized loss: each scene's gradient is scaled by "
                   "1/stop_grad(its own loss), so easy scenes are not drowned out by hard "
                   "ones (over-suppresses the near end in double talk: the shipped robust "
                   "checkpoint trains without it)")
    p.add_argument("--asym", type=float, default=0.0,
                   help="weight of the asymmetric speech-preservation term "
                   "(little_net_loss asym_weight)")
    p.add_argument("--width", type=int, default=1,
                   help="GRU width multiplier (little_net_init width=): 1 is the reference's "
                   "12,544-param geometry; 2 / 4 put K8 / K8b at H = 64 / 128")
    p.add_argument("--sisnr", type=float, default=0.0,
                   help="weight of the waveform SI-SNR preservation term (little_net_loss "
                   "sisnr_weight); implies gain_norm synthesis in the loss")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    n = int(args.seconds * SR) // 256 * 256
    scfg, kcfg = StftConfig(), KalmanConfig()
    net = little_net_init(width=args.width, generator=torch.Generator().manual_seed(args.seed),
                          device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    step = make_train_step(recipe_loss(args.balance, args.asym, args.sisnr),
                           recipe_optimizer(net, args.lr, args.steps), scfg=scfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    # the same 16 scenes at every evaluation (JAX's fixed PRNGKey(123))
    scenes = synthesize_scenes(scene_draws(torch.Generator(device=dev).manual_seed(EVAL_SEED),
                                           EVAL_SCENES, n), n)

    t0 = time.perf_counter()
    for i in range(args.steps):
        far, mic, near = synthesize_scenes(scene_draws(gen, args.batch, n), n)
        loss = step(linear_output(kcfg, far, mic, scfg), far, near, erb)
        if i % 200 == 0 or i == args.steps - 1:
            e1, e2, s1, s2 = eval_metrics(net, *scenes, erb, kcfg, scfg)
            print(f"step {i}: loss={float(loss):.4f} | echo-only ERLE stage1={float(e1):.2f} "
                  f"two-stage={float(e2):.2f} dB | double-talk SI-SNR lin={float(s1):.2f} "
                  f"enh={float(s2):.2f} dB ({time.perf_counter() - t0:.0f}s)", flush=True)

    e1, e2, s1, s2 = eval_metrics(net, *scenes, erb, kcfg, scfg)
    info = {
        "steps": args.steps,
        "echo_only_erle_stage1_db": round(float(e1), 2),
        "echo_only_erle_two_stage_db": round(float(e2), 2),
        "double_talk_sisnr_linear_db": round(float(s1), 2),
        "double_talk_sisnr_enhanced_db": round(float(s2), 2),
    }
    checkpoints.save(args.out, {"params": params_to_jax(net)}, info)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
