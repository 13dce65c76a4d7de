"""Echo scenes made on the device from a seed: the one generator every traffic
mix reads its parameters into.

A scene is a far end, the echo it leaves at the microphone, an optional near
end and a noise floor. The far and near ends are speech-like (a drifting-pitch
harmonic stack under a syllabic envelope with pauses, peak-normalised); the
echo is the far end through a memoryless loudspeaker soft clip and a random
exponentially decaying room response; a drawn share of the scenes carries
near-end speech (double talk). Rewritten in torch from the repository's
``benchmarks/scenes.py`` (``speech_like``, ``loudspeaker``, ``_rir``) so that a
batch is a few large calls on the card.

Every draw comes from one ``torch.Generator`` on the device in a fixed order,
and every scene's sizes are drawn from it, so a seed gives the same scenes.
"""

from __future__ import annotations

import math

import torch

SR = 16000
HARMONICS = ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (5, 0.2), (6, 0.12))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def speech_like(g, rows: int, n: int, f0: tuple[float, float], device) -> torch.Tensor:
    """(rows, n) float32: per row a pitch drawn in ``f0``, drifting by 8 %
    at 0.7 Hz, six harmonics with random phases, a 3.3 Hz syllabic
    envelope with pauses and a 0.02 noise floor, peak-normalised to 1."""
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    base = _uniform(g, (rows, 1), f0[0], f0[1], device)
    ph = _uniform(g, (rows, 8), 0.0, 6.28, device)
    f0_t = base * (1.0 + 0.08 * torch.sin(2 * math.pi * 0.7 * t + ph[:, :1]))
    phase = 2 * math.pi * torch.cumsum(f0_t, -1) / SR
    sig = torch.zeros(rows, n, device=device, dtype=torch.float64)
    for j, (k, a) in enumerate(HARMONICS):
        sig += a * torch.sin(k * phase + ph[:, 1 + j:2 + j])
    env = torch.clamp_min(torch.sin(2 * math.pi * 3.3 * t + ph[:, 7:8]) + 0.25, 0.0) ** 1.5
    sig = sig * env + 0.02 * torch.randn(rows, n, generator=g, device=device, dtype=torch.float64)
    sig = sig / (sig.abs().amax(-1, keepdim=True) + 1e-9)
    return sig.float()


def loudspeaker(x: torch.Tensor, drive: float) -> torch.Tensor:
    return torch.tanh(drive * x) / drive


def rooms(g, rows: int, taps: tuple[int, int], device) -> torch.Tensor:
    """(rows, taps[1]) responses: a length drawn in ``taps``, decay a quarter
    of it, Gaussian taps under the decay, zero past the length, peak 0.5."""
    n = taps[1]
    length = torch.randint(taps[0], taps[1] + 1, (rows, 1), generator=g, device=device)
    i = torch.arange(n, device=device)
    h = torch.exp(-i / (length / 4.0)) * torch.randn(rows, n, generator=g, device=device)
    h = torch.where(i < length, h, torch.zeros_like(h))
    return 0.5 * h / h.abs().amax(-1, keepdim=True)


def convolve(x: torch.Tensor, h: torch.Tensor, circular: bool) -> torch.Tensor:
    """Row-wise linear (or, with ``circular``, circular) convolution, by FFT
    in float64, truncated to x's length."""
    n = x.shape[-1]
    size = n if circular else n + h.shape[-1]
    y = torch.fft.irfft(torch.fft.rfft(x.double(), size) * torch.fft.rfft(h.double(), size), size)
    return y[..., :n].float()


def make(g, rows: int, n: int, mix: dict, device, *, circular: bool = False) -> dict:
    """A batch of ``rows`` scenes of ``n`` samples -> {"far", "mic", "near",
    "echo"}, each (rows, n) float32 on ``device``. ``mix`` holds the traffic's
    scene parameters: ``far_f0``, ``near_f0`` (Hz ranges), ``rir_taps``,
    ``drive`` (the soft clip), ``doubletalk`` (the share of rows with a near
    end), ``near_gain`` (its peak range relative to the far end's), ``noise``
    (the floor's standard deviation). ``circular`` wraps the echo so that a
    ring of ``n`` samples played in a loop has no seam."""
    far = speech_like(g, rows, n, tuple(mix["far_f0"]), device)
    h = rooms(g, rows, tuple(mix["rir_taps"]), device)
    echo = convolve(loudspeaker(far, mix["drive"]), h, circular)
    talk = (torch.rand(rows, 1, generator=g, device=device) < mix["doubletalk"]).float()
    gain = _uniform(g, (rows, 1), *mix["near_gain"], device).float()
    near = speech_like(g, rows, n, tuple(mix["near_f0"]), device) * gain * talk
    noise = mix["noise"] * torch.randn(rows, n, generator=g, device=device)
    return {"far": far, "mic": echo + near + noise, "near": near, "echo": echo}
