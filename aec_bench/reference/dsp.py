"""Plain signal pieces shared by the references: window, ERB filterbank, STFT,
iSTFT and the partitioned-block frequency-domain Kalman filter.

Written from the published descriptions in plain PyTorch and NumPy, with
``torch.fft`` for the STFT pair; nothing here imports the program. The
semantics (framing, pads, epsilons, the filter's update) follow the
configurations' sources:

- STFT: periodic window, both sides padded by ``win - hop``, frame t is
  ``rfft(window * frame)``; the spectrum is laid out ``[re || im]``.
- iSTFT: ``irfft`` of each frame times the window, overlap-add, division by
  the overlap-added squared window plus 1e-8, ``win - hop`` samples trimmed
  from both ends.
- ERB: Hohmann (2002) raised-cosine bands between ERB-uniform cutoffs, as
  SZU-Speech's ``ERB.py`` builds them.
- Kalman: per bin and partition a diagonal state covariance, transition
  factor ``a``, observation-noise psd smoothed from the residual, the
  update's gradient constrained to B causal taps; its transforms are
  products with the real DFT bases, built in float64.
"""

from __future__ import annotations

import numpy as np
import torch

EAR_Q, MIN_BW = 9.265, 24.7


def hann(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)


def _to_erb(f):
    return EAR_Q * np.log(1.0 + np.asarray(f, dtype=np.float64) / (MIN_BW * EAR_Q))


def _from_erb(e):
    return (np.exp(np.asarray(e, dtype=np.float64) / EAR_Q) - 1.0) * MIN_BW * EAR_Q


def erb_matrix(n_freqs: int = 257, bands: int = 32, max_freq: float = 8000.0) -> np.ndarray:
    """(n_freqs, bands) analysis matrix, float64: band i a half cosine over
    the bins strictly between cutoffs i and i + 2."""
    freqs = np.linspace(0.0, max_freq, n_freqs)
    cut = _from_erb(np.linspace(_to_erb(0.0), _to_erb(max_freq), bands + 2))
    out = np.zeros((n_freqs, bands))
    for i in range(bands):
        lo = int(np.min(np.where(freqs > cut[i])))
        hi = int(np.max(np.where(freqs < cut[i + 2])))
        centre = (_to_erb(cut[i]) + _to_erb(cut[i + 2])) / 2.0
        width = _to_erb(cut[i + 2]) - _to_erb(cut[i])
        out[lo:hi + 1, i] = np.cos((_to_erb(freqs[lo:hi + 1]) - centre) / width * np.pi)
    return out


def stft(x: torch.Tensor, win: int = 512, hop: int = 256) -> torch.Tensor:
    """[..., n] -> [..., T, 2K] with T = (n + 2 (win - hop) - win) // hop + 1."""
    pad = win - hop
    xp = torch.nn.functional.pad(x, (pad, pad))
    frames = xp.unfold(-1, win, hop) * torch.as_tensor(hann(win), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.cat([spec.real, spec.imag], dim=-1)


def magnitude(spec: torch.Tensor) -> torch.Tensor:
    k = spec.shape[-1] // 2
    re, im = spec[..., :k], spec[..., k:]
    return torch.sqrt(re * re + im * im + 1e-9)


def synth_frames(spec: torch.Tensor, win: int = 512) -> torch.Tensor:
    """[..., 2K] -> windowed time frames [..., win]."""
    k = spec.shape[-1] // 2
    frames = torch.fft.irfft(torch.complex(spec[..., :k], spec[..., k:]), n=win, dim=-1)
    return frames * torch.as_tensor(hann(win), dtype=spec.dtype, device=spec.device)


def istft(spec: torch.Tensor, win: int = 512, hop: int = 256) -> torch.Tensor:
    """[..., T, 2K] -> [..., (T - 1) hop + win - 2 (win - hop)]."""
    frames = synth_frames(spec, win)
    t = frames.shape[-2]
    r = win // hop
    out = frames.new_zeros((*frames.shape[:-2], t + r - 1, hop))
    for j in range(r):
        out[..., j:j + t, :] += frames[..., j * hop:(j + 1) * hop]
    out = out.flatten(-2)
    w2 = hann(win) ** 2
    env = np.zeros((t - 1) * hop + win)
    for f in range(t):
        env[f * hop:f * hop + win] += w2
    out = out / (torch.as_tensor(env, dtype=spec.dtype, device=spec.device) + 1e-8)
    pad = win - hop
    return out[..., pad:out.shape[-1] - pad]


def dft_bases(block: int):
    """float64 real bases of the 2B-point real DFT in ``[re || im]`` layout:
    ``fwd`` (2B, 2K), frame @ fwd = rfft(frame); ``inv`` (2K, 2B),
    spectrum @ inv = irfft(spectrum)."""
    n = 2 * block
    k = n // 2 + 1
    dft = np.fft.rfft(np.eye(n))
    fwd = np.concatenate([dft.real, dft.imag], axis=1)
    inv = np.concatenate([np.fft.irfft(np.eye(k), n=n), np.fft.irfft(1j * np.eye(k), n=n)], 0)
    return fwd, inv


def _cmul(a, b, k):
    """Complex products of ``[re || im]`` tensors of K bins."""
    ar, ai, br, bi = a[..., :k], a[..., k:], b[..., :k], b[..., k:]
    return torch.cat([ar * br - ai * bi, ar * bi + ai * br], -1)


class Kalman:
    """The PBFDKF of one batch of streams, one block at a time, its transforms
    products with the DFT's real bases (so a product's precision is the
    filter's).

    ``cfg`` holds ``n_blocks, a, psi_floor, obs_smooth, q_min, init_p``.
    State in ``[re || im]`` layout: ``w`` (..., L, 2K), ``x`` the far-spectrum
    ring (newest first); real: ``p`` (..., L, K), ``psi`` (..., K)."""

    def __init__(self, cfg: dict, lead: tuple, block: int, device, dtype=torch.float32):
        self.cfg, self.block, self.k = cfg, block, block + 1
        fwd, inv = dft_bases(block)
        self.fwd = torch.as_tensor(fwd, dtype=dtype, device=device)
        self.inv = torch.as_tensor(inv, dtype=dtype, device=device)
        n_l = cfg["n_blocks"]
        self.w = torch.zeros(*lead, n_l, 2 * self.k, dtype=dtype, device=device)
        self.x = torch.zeros(*lead, n_l, 2 * self.k, dtype=dtype, device=device)
        self.p = torch.full((*lead, n_l, self.k), cfg["init_p"], dtype=dtype, device=device)
        self.psi = torch.full((*lead, self.k), cfg["psi_floor"], dtype=dtype, device=device)

    def step(self, frame: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Far frame (..., 2B) of the last two far blocks, mic block (..., B)
        -> the residual block (..., B)."""
        c, b, k = self.cfg, self.block, self.k
        a = c["a"]
        self.x = torch.cat([(frame @ self.fwd).unsqueeze(-2), self.x[..., :-1, :]], dim=-2)
        w_mag = self.w[..., :k] ** 2 + self.w[..., k:] ** 2
        w_pred = a * self.w
        p_pred = a * a * self.p + (1.0 - a * a) * w_mag + c["q_min"]
        e = d - (torch.sum(_cmul(w_pred, self.x, k), dim=-2) @ self.inv)[..., b:]
        spec_e = e @ self.fwd[b:]  # the spectrum of [zeros || e]
        e_pow = spec_e[..., :k] ** 2 + spec_e[..., k:] ** 2
        psi = c["obs_smooth"] * self.psi + (1.0 - c["obs_smooth"]) * e_pow
        self.psi = torch.clamp_min(psi, c["psi_floor"])
        xr, xi = self.x[..., :k], self.x[..., k:]
        x2 = xr * xr + xi * xi
        den = torch.sum(x2 * p_pred, dim=-2) + 2.0 * self.psi
        er, ei = (spec_e[..., :k] / den).unsqueeze(-2), (spec_e[..., k:] / den).unsqueeze(-2)
        upd = torch.cat([p_pred * (xr * er + xi * ei), p_pred * (xr * ei - xi * er)], -1)
        # constrain: back to time, keep the first B taps, forward again
        upd = (upd @ self.inv[:, :b]) @ self.fwd[:b]
        self.w = w_pred + upd
        self.p = torch.clamp_min(p_pred * (1.0 - p_pred * x2 / den.unsqueeze(-2)),
                                 c["psi_floor"])
        return e

    def complex_w(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.w[..., :self.k], self.w[..., self.k:]


def kalman_cancel(cfg: dict, far: torch.Tensor, mic: torch.Tensor, block: int) -> torch.Tensor:
    """[..., n] far and mic (n a multiple of ``block``) -> the residual [..., n]."""
    n = mic.shape[-1]
    if n % block:
        raise ValueError(f"n = {n} is not a multiple of the block {block}")
    kal = Kalman(cfg, tuple(mic.shape[:-1]), block, mic.device, mic.dtype)
    farp = torch.nn.functional.pad(far, (block, 0))
    out = torch.empty_like(mic)
    for t in range(n // block):
        out[..., t * block:(t + 1) * block] = kal.step(
            farp[..., t * block:(t + 2) * block], mic[..., t * block:(t + 1) * block])
    return out
