"""Kernels K5 and K7: the NLMS stage 1 as one CUDA launch.

K5 replaces ``aec_tpu/kernels/pallas_nlms.py:242``
(``nlms_filter_fused_batched_bl``, ``pallas_call`` at ``:305``; wrapper
``nlms_cancel_fused_batched_bl`` at ``:341``). The kernel is
``csrc/nlms_batched.cu`` on ``nlms_block_step`` of ``csrc/bl_common.cuh``:
one CTA per utterance walks all blocks with the filter state in shared
memory, as K1 does for Kalman.

K7 replaces ``aec_tpu/kernels/pallas_nlms.py:94`` (``nlms_filter_fused``,
``pallas_call`` at ``:121``; wrapper ``nlms_cancel_fused`` at ``:156``): one
utterance on one thread-block cluster of 16 CTAs that split the bins
(``csrc/single_stream.cu``, the same template as K6).

Their plain version is the block loop of ``linear/nlms.py``
(:func:`nlms_cancel_plain`), which the wrappers take for CPU tensors only.
The JAX wrappers' TPU knobs (``tile``, ``unroll``, ``interpret``,
``dot_mode``, ``constrain_every``) have no meaning here: every product is
plain fp32, the exact per-update constraint.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import NlmsConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.consts import stage1_consts
from aec_tpu_torch.kernels.kalman import (
    KALMAN_ARGTYPES,
    check_inputs,
    launch_single,
    single_stream_lib,
)
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.nlms import nlms_cancel_plain

__all__ = ["nlms_cancel_fused", "nlms_cancel_fused_batched", "nlms_cancel_plain"]

_BLOCK = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("nlms_batched")
    p, i = ctypes.c_void_p, ctypes.c_int
    # the three bases and eight filter constants, as KALMAN_ARGTYPES
    lib.aec_nlms_batched.argtypes = [p, p, p, i, i, *KALMAN_ARGTYPES, i, p]
    lib.aec_nlms_batched.restype = ctypes.c_int
    lib.aec_nlms_n_blocks.restype = ctypes.c_int
    return lib


def nlms_operands(cfg: NlmsConfig, device: torch.device) -> list:
    """The stage-1 kernel arguments for NLMS: the bases of
    :func:`stage1_consts` (cached per device) and the eight constants of
    ``NlmsParams`` in ``csrc/bl_common.cuh``."""
    c = stage1_consts(_BLOCK, device)
    return [
        _build.ptr(c["fwd"]), _build.ptr(c["inv_tail"]), _build.ptr(c["inv_head"]),
        cfg.mu, cfg.eps, cfg.power_smooth, 1.0 - cfg.power_smooth, cfg.eps_rel, cfg.beta,
        cfg.err_smooth, 1.0 - cfg.err_smooth,
    ]


def nlms_cancel_fused_batched(
    cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [batch, n] -> {"wav": echo-cancelled [batch, n]} on K5.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain loop. ``n`` is zero-padded to a block multiple and the output is
    cut back to ``n``.
    """
    if far.device.type == "cpu":
        return {"wav": nlms_cancel_plain(cfg, far, mic, block=block)["wav"]}
    lib = _lib()
    check_inputs(cfg, far, mic, block, lib.aec_nlms_n_blocks(), 2)
    n = mic.shape[-1]
    farp, micp = ols.pad_to_blocks(far, block), ols.pad_to_blocks(mic, block)
    e = torch.empty_like(micp)
    err = lib.aec_nlms_batched(
        _build.ptr(farp), _build.ptr(micp), _build.ptr(e), farp.shape[0],
        farp.shape[1] // block, *nlms_operands(cfg, far.device), far.device.index,
        _build.stream_of(far),
    )
    _build.check(err, "nlms_batched")
    nlms_cancel_fused_batched.launches += 1
    return {"wav": e[:, :n]}


nlms_cancel_fused_batched.launches = 0


def nlms_cancel_fused(
    cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [n] -> {"wav": echo-cancelled [n]} on K7, one cluster.

    A CUDA tensor launches the kernel (or raises, also when the card cannot
    place the cluster); a CPU tensor takes the plain loop.
    """
    if far.device.type == "cpu":
        return {"wav": nlms_cancel_plain(cfg, far, mic, block=block)["wav"]}
    e = launch_single(single_stream_lib().aec_nlms_single, nlms_operands(cfg, far.device), cfg,
                      far, mic, block)
    nlms_cancel_fused.launches += 1
    return {"wav": e}


nlms_cancel_fused.launches = 0
