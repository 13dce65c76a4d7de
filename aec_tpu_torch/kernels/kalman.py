"""Kernel K1: the batched Kalman stage 1 as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_kalman.py:492``
(``kalman_filter_fused_batched_bl``, ``pallas_call`` at ``:573``; wrapper
``kalman_cancel_fused_batched_bl`` at ``:611``). The kernel is
``csrc/kalman_batched.cu`` on the shared step of ``csrc/bl_common.cuh``: one
CTA per utterance walks all blocks with the filter state in shared memory.
It is bound by L2 bandwidth (its DFT bases are re-read every step); the
source's header has the reckoning and the levers left.

Its plain version is the block loop of ``linear/kalman.py``
(:func:`kalman_cancel_plain`), which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.consts import stage1_consts
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.kalman import kalman_cancel_plain

__all__ = ["kalman_cancel_fused_batched", "kalman_cancel_plain"]

_BLOCK = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("kalman_batched")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.aec_kalman_batched.argtypes = [p, p, p, i, i, p, p, p, *[f] * 8, i, p]
    lib.aec_kalman_batched.restype = ctypes.c_int
    lib.aec_kalman_n_blocks.restype = ctypes.c_int
    return lib


def _check(cfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor, block: int,
           n_blocks: int) -> None:
    if far.device != mic.device or far.device.type != "cuda":
        raise ValueError(f"far/mic must be on one CUDA device, got {far.device}, {mic.device}")
    if far.dtype != torch.float32 or mic.dtype != torch.float32:
        raise TypeError(f"far/mic must be float32, got {far.dtype}, {mic.dtype}")
    if far.ndim != 2 or far.shape != mic.shape:
        raise ValueError(f"far/mic must be [batch, n] of one shape, got {far.shape}, {mic.shape}")
    if not (far.is_contiguous() and mic.is_contiguous()):
        raise ValueError("far/mic must be contiguous")
    if block != _BLOCK or cfg.n_blocks != n_blocks:
        raise ValueError(
            f"the kernel is built for block {_BLOCK} and {n_blocks} partitions, "
            f"got block {block} and n_blocks {cfg.n_blocks}"
        )


def kalman_cancel_fused_batched(
    cfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [batch, n] -> {"wav": echo-cancelled [batch, n]}.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain loop. ``n`` is zero-padded to a block multiple and the output is
    cut back to ``n``.
    """
    if far.device.type == "cpu":
        return {"wav": kalman_cancel_plain(cfg, far, mic, block=block)["wav"]}
    lib = _lib()
    _check(cfg, far, mic, block, lib.aec_kalman_n_blocks())
    n = mic.shape[-1]
    farp, micp = ols.pad_to_blocks(far, block), ols.pad_to_blocks(mic, block)
    e = torch.empty_like(micp)
    c = stage1_consts(block, far.device)
    a2 = cfg.a * cfg.a
    err = lib.aec_kalman_batched(
        _build.ptr(farp), _build.ptr(micp), _build.ptr(e), farp.shape[0],
        farp.shape[1] // block, _build.ptr(c["fwd"]), _build.ptr(c["inv_tail"]),
        _build.ptr(c["inv_head"]), cfg.a, a2, 1.0 - a2, cfg.q_min, cfg.obs_smooth,
        1.0 - cfg.obs_smooth, cfg.psi_floor, cfg.init_p, far.device.index,
        _build.stream_of(far),
    )
    _build.check(err, "kalman_batched")
    kalman_cancel_fused_batched.launches += 1
    return {"wav": e[:, :n]}


kalman_cancel_fused_batched.launches = 0
