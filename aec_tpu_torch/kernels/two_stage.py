"""Kernel K4: the whole two-stage pipeline (Kalman + LittleNet) as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_two_stage.py:134`` (``two_stage_fused``,
``pallas_call`` at ``:209``), the route of ``two_stage_cancel``'s batched
``quality="fast"`` calls. The kernel is ``csrc/two_stage.cu`` on
``two_stage_block_step`` of ``csrc/bl_common.cuh``: one CTA per utterance
walks T + 1 steps with both stages' state in shared memory, and the
stage-1 block reaches stage 2 in shared memory (device memory sees it only
as the ``linear_wav`` output). It runs the dense formulation of both
stages, so it is bound by each SM's L2 read rate of the DFT bases, where K1
and K2 run FFTs; the source's header has the reckoning.

:func:`two_stage_fused_plain` is its plain version: the K1-plain then
K2-plain composition, which is what the JAX package holds its kernel
against. ``normalize=False`` only, as in JAX: the offline pseudo-norm needs
the whole stage-1 output before stage 2 starts. The JAX wrapper's TPU knobs
(``tile``, ``interpret``, ``dot_mode``, ``vmem_limit_mb``, ``unroll``) have
no meaning here and are left out; every product is plain fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.kalman import KALMAN_ARGTYPES, kalman_operands
from aec_tpu_torch.kernels.stage2 import (
    STAGE2_ARGTYPES,
    check_net,
    little_net_apply_fused_plain,
    stage2_operands,
)
from aec_tpu_torch.linear.kalman import kalman_cancel_plain
from aec_tpu_torch.models.little_net import LittleNet


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("two_stage")
    p, i = ctypes.c_void_p, ctypes.c_int
    # the batch and blocks, the stage-1 geometry and operands, the bands, the
    # stage-2 operands
    lib.aec_two_stage.argtypes = [
        p, p, p, p, p, i, i, *KALMAN_ARGTYPES[:2], i, *KALMAN_ARGTYPES[2:], *STAGE2_ARGTYPES,
        i, i, p,
    ]
    lib.aec_two_stage.restype = ctypes.c_int
    lib.aec_two_stage_smem.argtypes = [i, i, i]
    lib.aec_two_stage_smem.restype = ctypes.c_longlong
    return lib


def _t_blocks(far: torch.Tensor, mic: torch.Tensor, scfg: StftConfig) -> int:
    if far.ndim != 2 or far.shape != mic.shape or far.shape[-1] % scfg.hop:
        raise ValueError(
            f"far/mic must be (batch, n) of one shape with n a multiple of hop "
            f"{scfg.hop}, got {tuple(far.shape)}, {tuple(mic.shape)}"
        )
    if scfg.fft_len != 2 * scfg.hop or scfg.win_len != scfg.fft_len:
        raise ValueError(f"the fused two-stage pipeline needs win = fft = 2 * hop, got {scfg}")
    return far.shape[-1] // scfg.hop


@torch.no_grad()
def two_stage_fused_plain(
    net: LittleNet, far: torch.Tensor, mic: torch.Tensor, erb: torch.Tensor, *,
    kcfg: KalmanConfig = KalmanConfig(), scfg: StftConfig = StftConfig(),
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """Plain version of K4: K1's plain block loop, then K2's plain frame
    recurrence on its output. (B, n) -> {wav, linear_wav (B, n), mask
    (B, n / hop + 1, E)}."""
    t_blocks = _t_blocks(far, mic, scfg)
    lin = kalman_cancel_plain(kcfg, far, mic, block=scfg.hop)["wav"]
    b = far.shape[0]
    out, mask = little_net_apply_fused_plain(
        net, lin.reshape(b, t_blocks, scfg.hop), far.reshape(b, t_blocks, scfg.hop),
        torch.as_tensor(erb, dtype=torch.float32, device=far.device), scfg,
        gain_norm=gain_norm,
    )
    return {"wav": out.reshape(b, -1), "linear_wav": lin, "mask": mask}


def _check(far: torch.Tensor, mic: torch.Tensor, kcfg: KalmanConfig) -> None:
    if far.device.type != "cuda" or mic.device != far.device:
        raise ValueError(f"far/mic must be on one CUDA device, got {far.device}, {mic.device}")
    if far.dtype != torch.float32 or mic.dtype != torch.float32:
        raise TypeError(f"far/mic must be float32, got {far.dtype}, {mic.dtype}")
    if not (far.is_contiguous() and mic.is_contiguous()):
        raise ValueError("far/mic must be contiguous")
    if kcfg.n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {kcfg.n_blocks}")


def two_stage_fused(
    net: LittleNet, far: torch.Tensor, mic: torch.Tensor, erb: torch.Tensor, *,
    kcfg: KalmanConfig = KalmanConfig(), scfg: StftConfig = StftConfig(),
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """Full two-stage AEC in one launch: far/mic (B, n), n % hop == 0 ->
    {"wav": (B, n), "linear_wav": (B, n), "mask": (B, n / hop + 1, E)}.

    A CUDA tensor launches K4 (or raises); a CPU tensor takes
    :func:`two_stage_fused_plain`."""
    if far.device.type == "cpu":
        return two_stage_fused_plain(net, far, mic, erb, kcfg=kcfg, scfg=scfg,
                                     gain_norm=gain_norm)
    t_blocks = _t_blocks(far, mic, scfg)
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    lib = _lib()
    _check(far, mic, kcfg)
    check_net(net, erb, scfg, far.device)
    b, bands = far.shape[0], erb.shape[-1]
    _build.check_smem(lib.aec_two_stage_smem(scfg.hop, kcfg.n_blocks, bands), far.device,
                      "the two-stage kernel")
    out, lin = torch.empty_like(far), torch.empty_like(far)
    mask = far.new_empty((b, t_blocks + 1, bands))
    keep = stage2_operands(net, erb, scfg)
    s1 = kalman_operands(kcfg, far.device, scfg.hop)
    err = lib.aec_two_stage(
        _build.ptr(far), _build.ptr(mic), _build.ptr(out), _build.ptr(lin), _build.ptr(mask),
        b, t_blocks, *s1[:2], bands, *s1[2:], *map(_build.ptr, keep),
        int(gain_norm), far.device.index, _build.stream_of(far),
    )
    _build.check(err, "two_stage")
    two_stage_fused.launches += 1
    return {"wav": out, "linear_wav": lin, "mask": mask}


two_stage_fused.launches = 0
