"""Constant bases of the two CUDA kernels, as plain fp32 tensors cached per
device (counterpart of ``bl_common.stage1_consts`` / ``stage2_consts`` /
``stage2_vecs`` in the JAX package).

The JAX kernels split every constant into bf16 hi/lo parts and a separate
Nyquist column because the TPU's matrix unit multiplies in bf16. The CUDA
kernels multiply in plain fp32 (FFMA), so each basis is one fp32 matrix,
built on the host in float64 exactly as the JAX package builds it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aec_tpu_torch.dsp.stft import StftConfig, _bases
from aec_tpu_torch.dsp.windows import periodic_window
from aec_tpu_torch.linear import overlap_save as ols


@functools.lru_cache(maxsize=8)
def stage1_consts(block: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The stage-1 bases, row-major fp32:

    fwd      (2B, 2K) — frame -> ri spectrum; rows [B, 2B) give the residual
                        spectrum of [0 || e], rows [0, B) the constraint tail
    inv_tail (2K, B)  — ri spectrum -> last half of the irfft (echo estimate)
    inv_head (2K, B)  — ri spectrum -> first half of the irfft (constraint
                        head; the constraint is inv_head @ fwd[:B])
    """
    fwd, inv_tail, _ = ols._dft_mats(block)
    k = block + 1
    inv = np.concatenate(
        [np.fft.irfft(np.eye(k), n=2 * block), np.fft.irfft(1j * np.eye(k), n=2 * block)],
        axis=0,
    )  # (2K, 2B)
    mats = {"fwd": fwd, "inv_tail": inv_tail, "inv_head": inv[:, :block]}
    return {
        name: torch.as_tensor(np.ascontiguousarray(m, dtype=np.float32), device=device)
        for name, m in mats.items()
    }


@functools.lru_cache(maxsize=8)
def stage2_consts(cfg: StftConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """The stage-2 bases, row-major fp32:

    analysis  (win, 2K) — windowed analysis DFT of a frame
    synthesis (2K, win) — windowed pinv synthesis
    inv_env   (hop,)    — inverse interior OLA envelope 1/(w²[:hop] + w²[hop:] + 1e-8)
    window    (win,)    — the window itself (K2's FFT phases apply it to the
                          frames and to the inverse FFT, which with
                          window = FFT is the pinv synthesis)
    """
    analysis, synthesis = _bases(cfg)
    window = periodic_window(cfg.win_type, cfg.win_len)
    w2 = window ** 2
    inv_env = 1.0 / (w2[: cfg.hop] + w2[cfg.hop :] + 1e-8)
    mats = {"analysis": analysis, "synthesis": synthesis, "inv_env": inv_env, "window": window}
    return {
        name: torch.as_tensor(np.ascontiguousarray(m, dtype=np.float32), device=device)
        for name, m in mats.items()
    }
