"""Overlap-save machinery for the stage-1 adaptive filters
(counterpart of ``aec_tpu/linear/overlap_save.py``).

Block size B, FFT size N = 2B; far-end frame t is the rfft of samples
[(t-1)B, (t+1)B) (a leading zero block); the filter output is the LAST B
samples of the inverse FFT, which models linear convolution exactly.

Spectra are REAL tensors in "ri" layout ``[..., 2K]`` (real parts in [0, K),
imaginary in [K, 2K)), and every transform is a matmul with a fixed DFT
basis built on the host in float64 and cast to float32 — the same matrices
the JAX package builds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _dft_mats(block: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fwd [N, 2K], inv_tail [2K, block], constrain [2K, 2K]) float32."""
    n = 2 * block
    k = n // 2 + 1
    dft = np.fft.rfft(np.eye(n))  # (N, K) complex
    fwd = np.concatenate([dft.real, dft.imag], axis=1)  # (N, 2K)
    inv = np.concatenate(
        [np.fft.irfft(np.eye(k), n=n), np.fft.irfft(1j * np.eye(k), n=n)], axis=0
    )  # (2K, N)
    constrain = inv[:, :block] @ fwd[:block, :]  # (2K, 2K)
    return (
        fwd.astype(np.float32),
        inv[:, block:].astype(np.float32),  # last-half columns only
        constrain.astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _mat(block: int, which: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dft_mats(block)[which], device=device)


def ri_split(x_ri: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 2K] -> ([..., K], [..., K]) real/imag halves."""
    k = x_ri.shape[-1] // 2
    return x_ri[..., :k], x_ri[..., k:]


def ri_join(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.cat([re, im], dim=-1)


def pad_to_blocks(wav: torch.Tensor, block: int) -> torch.Tensor:
    """Right-pad the last axis with zeros up to a block multiple."""
    rem = (-wav.shape[-1]) % block
    return F.pad(wav, (0, rem)) if rem else wav


def far_end_spectra(far: torch.Tensor, block: int) -> torch.Tensor:
    """[..., n] (n % block == 0) -> [..., T, 2K] ri frames.

    Frame t covers samples [(t-1)B, (t+1)B) with a leading zero block, so
    frame t is causally aligned with mic block t.
    """
    farp = F.pad(far, (block, 0))
    frames = farp.unfold(-1, 2 * block, block)  # [..., T, 2B]
    return torch.matmul(frames, _mat(block, 0, far.device))


def mic_blocks(mic: torch.Tensor, block: int) -> torch.Tensor:
    """[..., n] -> [..., T, B] contiguous blocks."""
    return mic.reshape(*mic.shape[:-1], -1, block)


def spectrum_to_block(y_ri: torch.Tensor, block: int) -> torch.Tensor:
    """Last B samples of the inverse FFT — the linear-convolution output."""
    return torch.matmul(y_ri, _mat(block, 1, y_ri.device))


def block_to_spectrum(e_block: torch.Tensor, block: int) -> torch.Tensor:
    """rfft of [zeros_B || e_block] -> ri spectrum (== e_block @ fwd[B:])."""
    return torch.matmul(e_block, _mat(block, 0, e_block.device)[block:, :])


def constrain_gradient(g_ri: torch.Tensor, block: int) -> torch.Tensor:
    """Project per-partition updates onto causal B-tap time support
    (irfft -> zero the last half -> rfft, as one (2K, 2K) projection)."""
    return torch.matmul(g_ri, _mat(block, 2, g_ri.device))
