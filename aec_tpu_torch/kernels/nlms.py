"""Kernels K5 and K7: the NLMS stage 1 as one CUDA launch.

K5 replaces ``aec_tpu/kernels/pallas_nlms.py:242``
(``nlms_filter_fused_batched_bl``, ``pallas_call`` at ``:305``; wrapper
``nlms_cancel_fused_batched_bl`` at ``:341``). The kernel is
``csrc/nlms_batched.cu``: one CTA per utterance walks all blocks with the
filter state in shared memory, as K1 does for Kalman, on the FFT step of
``csrc/stage1_fft.cuh`` (``nlms_block_step_fft``; the plan and twiddles from
:mod:`kernels.fft_plan`). A block with a prime factor other than 2, 3 and 5
takes the dense step (``csrc/bl_common.cuh``, DFT bases read from L2);
``steps`` counts which ran.

K7 replaces ``aec_tpu/kernels/pallas_nlms.py:94`` (``nlms_filter_fused``,
``pallas_call`` at ``:121``; wrapper ``nlms_cancel_fused`` at ``:156``):
``csrc/single_stream.cu``, the same template and routes as K6 (one
utterance on one CTA with every transform in one warp; a block without a
radix plan on one cluster of 16 CTAs), ``steps`` counting which ran.

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
from aec_tpu_torch.kernels.kalman import (
    FFT_ARGTYPES,
    KALMAN_ARGTYPES,
    check_inputs,
    fft_operands,
    launch_single,
    nlms_constants,
    stage1_operands,
    step_for,
)
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.nlms import nlms_cancel_plain

__all__ = ["nlms_cancel_fused", "nlms_cancel_fused_batched", "nlms_cancel_plain",
           "nlms_constants"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("nlms_batched")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_nlms_batched.argtypes = [p, p, p, i, i, *KALMAN_ARGTYPES, i, p]
    lib.aec_nlms_batched_fft.argtypes = [p, p, p, i, i, *FFT_ARGTYPES, i, p]
    for fn in (lib.aec_nlms_batched, lib.aec_nlms_batched_fft):
        fn.restype = ctypes.c_int
    for fn in (lib.aec_nlms_smem, lib.aec_nlms_fft_smem):
        fn.argtypes = [i, i]
        fn.restype = ctypes.c_longlong
    return lib


def launch_batched(cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, e: torch.Tensor,
                   block: int) -> str:
    """Launch K5 over far/mic (batch, T * block) into ``e``: the step of
    :func:`step_for`. Returns the step that ran, ``"fft"`` or ``"dense"``.
    Raises if one CTA cannot hold the step's shared memory."""
    lib, dev = _lib(), far.device
    head = (_build.ptr(far), _build.ptr(mic), _build.ptr(e), far.shape[0], far.shape[1] // block)
    step, what = step_for(block), "the batched NLMS kernel"
    if step == "fft":
        _build.check_smem(lib.aec_nlms_fft_smem(block, cfg.n_blocks), dev, what)
        entry, operands = lib.aec_nlms_batched_fft, fft_operands(cfg, dev, block)
    else:
        _build.check_smem(lib.aec_nlms_smem(block, cfg.n_blocks), dev, what)
        entry, operands = lib.aec_nlms_batched, stage1_operands(cfg, dev, block)
    _build.check(entry(*head, *operands, dev.index, _build.stream_of(far)), "nlms_batched")
    return step


def nlms_cancel_fused_batched(
    cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [batch, n] -> {"wav": echo-cancelled [batch, n]} on K5.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain loop. ``n`` is zero-padded to a block multiple and the output is
    cut back to ``n``. ``steps`` counts the launches of the FFT step and of
    the dense step (a block with a prime factor other than 2, 3, 5).
    """
    if far.device.type == "cpu":
        return {"wav": nlms_cancel_plain(cfg, far, mic, block=block)["wav"]}
    check_inputs(cfg, far, mic, block, 2)
    n = mic.shape[-1]
    farp, micp = ols.pad_to_blocks(far, block), ols.pad_to_blocks(mic, block)
    e = torch.empty_like(micp)
    nlms_cancel_fused_batched.steps[launch_batched(cfg, farp, micp, e, block)] += 1
    nlms_cancel_fused_batched.launches += 1
    return {"wav": e[:, :n]}


nlms_cancel_fused_batched.launches = 0
nlms_cancel_fused_batched.steps = {"fft": 0, "dense": 0}


def nlms_cancel_fused(
    cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [n] -> {"wav": echo-cancelled [n]} on K7.

    A CUDA tensor launches the kernel (or raises, also when the card cannot
    place the dense route's cluster); a CPU tensor takes the plain loop.
    ``steps`` counts the launches of the FFT route and of the dense route.
    """
    if far.device.type == "cpu":
        return {"wav": nlms_cancel_plain(cfg, far, mic, block=block)["wav"]}
    e, step = launch_single(cfg, far, mic, block)
    nlms_cancel_fused.steps[step] += 1
    nlms_cancel_fused.launches += 1
    return {"wav": e}


nlms_cancel_fused.launches = 0
nlms_cancel_fused.steps = {"fft": 0, "dense": 0}
