"""STFT / iSTFT as DFT-basis matmuls (counterpart of ``aec_tpu/dsp/stft.py``).

Analysis is ``rfft(window * frame)`` stacked as ``[real || imag]`` columns;
synthesis is the Moore-Penrose pseudo-inverse of the unwindowed analysis
basis, re-windowed, followed by overlap-add and division by the OLA'd
squared-window envelope (+1e-8), with ``win_len - hop`` samples trimmed from
both ends. The bases are built on the host in float64 (the same
construction as the JAX package) and cast to the input's dtype and device.

Spec layout: frame-major ``[..., T, 2K]`` with K = fft//2 + 1, real parts in
columns [0, K) and imaginary parts in [K, 2K).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from aec_tpu_torch.dsp.windows import periodic_window


@dataclasses.dataclass(frozen=True)
class StftConfig:
    win_len: int = 512
    hop: int = 256
    fft_len: int = 512
    win_type: str = "hann"

    @property
    def n_freqs(self) -> int:
        return self.fft_len // 2 + 1

    @property
    def pad(self) -> int:
        return self.win_len - self.hop


@functools.lru_cache(maxsize=None)
def _bases(cfg: StftConfig) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (analysis, synthesis) basis matrices, float64.

    analysis:  (win_len, 2K) — frame @ A == [Re rfft(w*frame) || Im ...]
    synthesis: (2K, win_len) — spec  @ S == windowed pinv reconstruction
    """
    window = periodic_window(cfg.win_type, cfg.win_len)
    dft = np.fft.rfft(np.eye(cfg.fft_len))[: cfg.win_len]  # (win, K) complex
    basis = np.concatenate([dft.real, dft.imag], axis=1)  # (win, 2K)
    analysis = basis * window[:, None]
    synthesis = np.linalg.pinv(basis.T).T * window[None, :]  # (2K, win)
    return analysis, synthesis


@functools.lru_cache(maxsize=32)
def _basis_tensor(cfg: StftConfig, which: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_bases(cfg)[which], dtype=dtype, device=device)


def analysis_matrix(cfg: StftConfig, *, device=None, dtype=torch.float32) -> torch.Tensor:
    return _basis_tensor(cfg, 0, torch.device(device or "cpu"), dtype)


def synthesis_matrix(cfg: StftConfig, *, device=None, dtype=torch.float32) -> torch.Tensor:
    return _basis_tensor(cfg, 1, torch.device(device or "cpu"), dtype)


def frame_signal(x: torch.Tensor, win_len: int, hop: int) -> torch.Tensor:
    """Strided framing ``[..., n] -> [..., F, win_len]`` (a view)."""
    n = x.shape[-1]
    if n < win_len:
        raise ValueError(f"signal too short to frame: {n} < {win_len}")
    return x.unfold(-1, win_len, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``[..., F, win] -> [..., (F-1)*hop + win]`` (hop | win).

    Chunk j of frame f lands at output block f + j: r = win/hop shifted
    block stacks summed together.
    """
    *lead, n_frames, win_len = frames.shape
    if win_len % hop != 0:
        raise ValueError("overlap_add requires hop | win_len")
    r = win_len // hop
    out_blocks = n_frames + r - 1
    total = frames.new_zeros((*lead, out_blocks, hop))
    for j in range(r):
        total[..., j : j + n_frames, :] += frames[..., j * hop : (j + 1) * hop]
    return total.reshape(*lead, out_blocks * hop)


@functools.lru_cache(maxsize=64)
def _ola_envelope_np(n_frames: int, cfg: StftConfig) -> np.ndarray:
    wsq = periodic_window(cfg.win_type, cfg.win_len) ** 2
    out = np.zeros((n_frames - 1) * cfg.hop + cfg.win_len)
    for f in range(n_frames):
        out[f * cfg.hop : f * cfg.hop + cfg.win_len] += wsq
    return out


def ola_envelope(n_frames: int, cfg: StftConfig, *, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """OLA of the squared window over ``n_frames`` frames (host precompute);
    length (n_frames-1)*hop + win."""
    return torch.as_tensor(_ola_envelope_np(n_frames, cfg), dtype=dtype, device=device)


def stft(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Analysis STFT: ``[..., n] -> [..., F, 2K]`` (real || imag columns)."""
    xp = F.pad(x, (cfg.pad, cfg.pad))
    frames = frame_signal(xp, cfg.win_len, cfg.hop)
    a = analysis_matrix(cfg, device=x.device, dtype=x.dtype)
    return torch.matmul(frames, a)


def istft(spec: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Synthesis iSTFT: ``[..., F, 2K] -> [..., n]``: pinv-basis projection,
    overlap-add, division by (envelope + 1e-8), trim win-hop per side."""
    s = synthesis_matrix(cfg, device=spec.device, dtype=spec.dtype)
    frames = torch.matmul(spec, s)  # (..., F, win)
    wav = overlap_add(frames, cfg.hop)
    env = ola_envelope(spec.shape[-2], cfg, device=spec.device, dtype=spec.dtype)
    wav = wav / (env + 1e-8)
    return wav[..., cfg.pad : wav.shape[-1] - cfg.pad]


def split_complex(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., 2K] -> ([..., K], [..., K])`` real/imag split."""
    k = spec.shape[-1] // 2
    return spec[..., :k], spec[..., k:]


def magnitude(spec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """|spec| with the reference's in-sqrt epsilon."""
    re, im = split_complex(spec)
    return torch.sqrt(re * re + im * im + eps)
