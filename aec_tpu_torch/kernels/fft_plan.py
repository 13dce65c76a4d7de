"""Host side of the FFTs of K1 / K12's stage-1 step and K2's phases (``csrc/fft.cuh``).

Their transforms are real FFTs of length N = 2B (B the block, K2's hop):
each is a complex FFT of length M = B over the even / odd samples packed as
(re, im), run as a Stockham auto-sort schedule of radix-8/4/2 passes (and
radix-5/3 passes where B has those factors), then the real-FFT split of the
M complex outputs into K = B + 1 bins. The inverse drops the imaginary
parts of bins 0 and K - 1 before the split, as ``np.fft.irfft`` does and as
the dense inverse bases of :func:`kernels.consts.stage1_consts` do.

This module builds what the kernel reads in place of the dense bases: the
radix plan of M and the table of twiddles W_N^m = exp(-2 pi i m / N) for
m in [0, M), in float64 rounded to fp32. It also holds a plain-torch model
of the same schedule (the passes' index maps, twiddle indices and edge
rules), which the CPU tests hold against the dense bases and ``torch.fft``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

MAX_PASSES = 12  # the kernel's plan holds at most this many radix passes


def radix_plan(block: int) -> tuple[int, ...] | None:
    """The radices of the complex FFT of length M = ``block``, in the order
    the passes run (8s, then 4, 2, 5s, 3s), or None when ``block`` < 2 or
    has a prime factor other than 2, 3 and 5 (that geometry keeps the dense
    step)."""
    if block < 2:
        return None
    m, plan = block, []
    for r in (8, 4, 2):
        while m % r == 0:
            plan.append(r)
            m //= r
    for r in (5, 3):
        while m % r == 0:
            plan.append(r)
            m //= r
    return tuple(plan) if m == 1 and len(plan) <= MAX_PASSES else None


@functools.lru_cache(maxsize=8)
def _twiddles_f64(block: int) -> np.ndarray:
    m = np.arange(block)
    return np.exp(-2j * np.pi * m / (2 * block))


@functools.lru_cache(maxsize=8)
def twiddles(block: int, device: torch.device) -> torch.Tensor:
    """(B, 2) fp32 [re, im] of W_2B^m, m in [0, B): the kernel's table,
    cached per device so its pointer stays valid."""
    w = _twiddles_f64(block)
    t = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(t), device=device)


# ---------------------------------------------------------------- plain-torch model


def _table(block: int) -> torch.Tensor:
    t = twiddles(block, torch.device("cpu"))
    return torch.complex(t[:, 0], t[:, 1])


def _tw(table: torch.Tensor, m: torch.Tensor, inverse: bool) -> torch.Tensor:
    """W_N^m for m in [0, N) from the half table (W_N^(m + M) = -W_N^m);
    conjugated for the inverse."""
    half = table.shape[0]
    w = torch.where(m < half, table[m % half], -table[m % half])
    return w.conj() if inverse else w


def _dft(v: list[torch.Tensor], inverse: bool) -> list[torch.Tensor]:
    r = len(v)
    sign = 1.0 if inverse else -1.0
    out = []
    for k in range(r):
        acc = torch.zeros_like(v[0])
        for n in range(r):
            ang = sign * 2.0 * math.pi * ((n * k) % r) / r
            acc = acc + v[n] * complex(math.cos(ang), math.sin(ang))
        out.append(acc)
    return out


def fft_passes(z: torch.Tensor, plan: tuple[int, ...], table: torch.Tensor,
               inverse: bool = False) -> torch.Tensor:
    """The kernel's Stockham schedule on complex ``z`` (..., M): pass p of
    radix R reads element j + r M/R (j < M/R, r < R), multiplies it by the
    twiddle W_M^(r k M/(Ns R)) with k = j mod Ns, takes the R-point DFT and
    writes element (j div Ns) Ns R + k + r Ns; Ns is the product of the
    earlier radices. Unscaled; the inverse conjugates every twiddle."""
    m = z.shape[-1]
    ns = 1
    for r in plan:
        mr = m // r
        j = torch.arange(mr)
        k = j % ns
        step = m // (ns * r)
        v = [z[..., j + q * mr] for q in range(r)]
        v = [v[q] * _tw(table, 2 * q * k * step, inverse) for q in range(r)]
        v = _dft(v, inverse)
        d = (j // ns) * ns * r + k
        out = torch.empty_like(z)
        for q in range(r):
            out[..., d + q * ns] = v[q]
        z, ns = out, ns * r
    return z


def rfft(x: torch.Tensor, block: int) -> torch.Tensor:
    """Real frames (..., 2B) -> ri spectra (..., 2K) as the kernel computes
    them: z[n] = x[2n] + i x[2n+1], the passes, then the split
    X[k] = (Z[k] + Z*[M-k]) / 2 - i W_N^k (Z[k] - Z*[M-k]) / 2."""
    plan, table = radix_plan(block), _table(block)
    z = torch.complex(x[..., 0::2].float(), x[..., 1::2].float())
    zz = fft_passes(z, plan, table)
    k = torch.arange(block + 1)
    a = zz[..., k % block]
    b = zz[..., (block - k) % block].conj()
    w = torch.where(k < block, table[k % block], torch.tensor(-1.0 + 0j, dtype=table.dtype))
    x_k = 0.5 * (a + b) + w * (-0.5j * (a - b))
    return torch.cat([x_k.real, x_k.imag], dim=-1)


def irfft(x_ri: torch.Tensor, block: int, half: str) -> torch.Tensor:
    """ri spectra (..., 2K) -> the ``"head"`` (samples [0, B)) or ``"tail"``
    ([B, 2B)) of their inverse real FFT, as the kernel computes it: the
    imaginary parts of bins 0 and K - 1 are dropped, then
    Z'[k] = ((X[k] + X*[M-k]) + i conj(W_N^k) (X[k] - X*[M-k])) / N for
    k < M, the inverse passes, and x[2n] = Re z[n], x[2n+1] = Im z[n]."""
    plan, table = radix_plan(block), _table(block)
    kk = block + 1
    re, im = x_ri[..., :kk].float(), x_ri[..., kk:].float().clone()
    im[..., 0] = 0.0
    im[..., block] = 0.0
    spec = torch.complex(re, im)
    k = torch.arange(block)
    a, b = spec[..., k], spec[..., block - k].conj()
    zp = ((a + b) + 1j * table[k].conj() * (a - b)) / (2 * block)
    z = fft_passes(zp, plan, table, inverse=True)
    x = torch.stack([z.real, z.imag], dim=-1).reshape(*z.shape[:-1], 2 * block)
    return x[..., :block] if half == "head" else x[..., block:]
