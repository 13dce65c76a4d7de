"""Kernels K1, K12 and K6: the Kalman stage 1 as one CUDA launch.

K1 replaces ``aec_tpu/kernels/pallas_kalman.py:492``
(``kalman_filter_fused_batched_bl``, ``pallas_call`` at ``:573``; wrapper
``kalman_cancel_fused_batched_bl`` at ``:611``). The kernel is
``csrc/kalman_batched.cu``: one CTA per utterance walks all blocks with the
filter state in shared memory, its transforms real FFTs in shared memory
(``csrc/fft.cuh``; the plan and twiddles from :mod:`kernels.fft_plan`). A
block with a prime factor other than 2, 3 and 5 takes the kernel's dense
step (``csrc/bl_common.cuh``, DFT bases read from L2) instead; the wrappers
count which step ran in ``steps``. The source's header has the reckoning.

K12 replaces ``aec_tpu/kernels/pallas_kalman.py:303``
(``kalman_filter_fused_batched``, ``pallas_call`` at ``:349``), the filter-
level entry that takes far-frame spectra: the same source, instantiated to
load each step's spectrum in place of the in-kernel analysis.

K6 replaces ``aec_tpu/kernels/pallas_kalman.py:150`` (``kalman_filter_fused``,
``pallas_call`` at ``:178``; wrapper ``kalman_cancel_fused`` at ``:646``),
the single-stream kernel, ``csrc/single_stream.cu`` (the same source is K7,
the NLMS single-stream kernel of ``kernels/nlms.py``). Where the block has a
radix plan it runs one utterance on one CTA, K1's FFT step with every
transform in one warp and four CTA barriers a step; a block without one
takes the dense route, one thread-block cluster of 16 CTAs that split the
bins. ``steps`` counts which ran (:func:`step_for` picks it).

Their plain version is the block loop of ``linear/kalman.py``
(:func:`kalman_cancel_plain`), which the wrappers take for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.consts import stage1_consts
from aec_tpu_torch.kernels.fft_plan import radix_plan, twiddles
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.kalman import kalman_cancel_plain, kalman_filter

__all__ = ["kalman_cancel_fused", "kalman_cancel_fused_batched", "kalman_cancel_plain",
           "kalman_filter_fused_batched", "kalman_filter_fused_batched_plain"]

# ctypes types of the stage-1 arguments every dense-step kernel takes: the
# block and the partition count, the three bases, then the eight filter
# constants (see :func:`stage1_operands`)
KALMAN_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 8
# ... and every FFT-step kernel: the block and the partition count, the
# twiddle table, the radix plan and its length, the eight constants
FFT_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int] + [ctypes.c_float] * 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("kalman_batched")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.aec_kalman_batched, lib.aec_kalman_batched_spectra):
        fn.argtypes = [p, p, p, i, i, *KALMAN_ARGTYPES, i, p]
        fn.restype = ctypes.c_int
    lib.aec_kalman_batched_fft.argtypes = [p, p, p, i, i, i, i, p, ctypes.POINTER(i), i, i,
                                           *[ctypes.c_float] * 8, i, p]
    lib.aec_kalman_batched_fft.restype = ctypes.c_int
    for fn in (lib.aec_kalman_smem, lib.aec_kalman_fft_smem):
        fn.argtypes = [i, i]
        fn.restype = ctypes.c_longlong
    return lib


@functools.cache
def single_stream_lib() -> ctypes.CDLL:
    """``csrc/single_stream.cu``: K6 and K7, the FFT route on one CTA
    (``aec_kalman_single_fft``, ``aec_nlms_single_fft``) and the dense route
    on one cluster (``aec_kalman_single``, ``aec_nlms_single``;
    ``aec_single_cluster()`` is its cluster size)."""
    return bind_single(_build.load("single_stream"))


def bind_single(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/single_stream.cu``) with its entries'
    argument and result types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.aec_kalman_single, lib.aec_nlms_single):
        fn.argtypes = [p, p, p, i, *KALMAN_ARGTYPES, i, p]
        fn.restype = ctypes.c_int
    for fn in (lib.aec_kalman_single_fft, lib.aec_nlms_single_fft):
        fn.argtypes = [p, p, p, i, *FFT_ARGTYPES, i, p]
        fn.restype = ctypes.c_int
    lib.aec_single_cluster.restype = ctypes.c_int
    for fn in (lib.aec_single_smem, lib.aec_single_fft_smem):
        fn.argtypes = [i, i, i]
        fn.restype = ctypes.c_longlong
    return lib


def step_for(block: int) -> str:
    """The step every stage-1 kernel takes at this block: ``"fft"`` where
    :func:`radix_plan` takes it (a block >= 2 whose prime factors are 2, 3
    and 5), else ``"dense"``."""
    return "dense" if radix_plan(block) is None else "fft"


def filter_constants(cfg: KalmanConfig) -> list[float]:
    """The eight Kalman constants every stage-1 kernel takes."""
    a2 = cfg.a * cfg.a
    return [cfg.a, a2, 1.0 - a2, cfg.q_min, cfg.obs_smooth, 1.0 - cfg.obs_smooth, cfg.psi_floor,
            cfg.init_p]


def nlms_constants(cfg: NlmsConfig) -> list[float]:
    """The eight constants of ``NlmsParams`` in ``csrc/bl_common.cuh``."""
    return [cfg.mu, cfg.eps, cfg.power_smooth, 1.0 - cfg.power_smooth, cfg.eps_rel, cfg.beta,
            cfg.err_smooth, 1.0 - cfg.err_smooth]


def stage1_constants(cfg) -> list[float]:
    """The filter's eight constants: NLMS's for an ``NlmsConfig``, else Kalman's."""
    return nlms_constants(cfg) if isinstance(cfg, NlmsConfig) else filter_constants(cfg)


def stage1_operands(cfg, device: torch.device, block: int) -> list:
    """The dense-step arguments of ``KALMAN_ARGTYPES``: the geometry, the
    bases of :func:`stage1_consts` (cached per device, so their pointers stay
    valid) and the filter's constants."""
    c = stage1_consts(block, device)
    return [
        block, cfg.n_blocks,
        _build.ptr(c["fwd"]), _build.ptr(c["inv_tail"]), _build.ptr(c["inv_head"]),
        *stage1_constants(cfg),
    ]


def fft_operands(cfg, device: torch.device, block: int) -> list:
    """The FFT-step arguments of ``FFT_ARGTYPES``: the geometry, the twiddle
    table (cached per device), the radix plan and the filter's constants."""
    plan = radix_plan(block)
    return [block, cfg.n_blocks, _build.ptr(twiddles(block, device)),
            (ctypes.c_int * len(plan))(*plan), len(plan), *stage1_constants(cfg)]


def launch_batched(cfg: KalmanConfig, x: torch.Tensor, mic: torch.Tensor, e: torch.Tensor,
                   block: int, spectra_in: bool) -> str:
    """Launch K1 (far blocks ``x``) or K12 (far-frame spectra ``x``) over
    ``mic`` (batch, T * block; K12: batch, T, block) into ``e``: the step of
    :func:`step_for`. Returns the step that ran, ``"fft"`` or ``"dense"``.
    Raises if one CTA cannot hold the step's shared memory."""
    lib, dev = _lib(), x.device
    batch, t_blocks = mic.shape[0], mic.shape[1] if spectra_in else mic.shape[-1] // block
    step = step_for(block)
    what = "the batched Kalman kernel"
    head = (_build.ptr(x), _build.ptr(mic), _build.ptr(e), batch, t_blocks)
    if step == "dense":
        _build.check_smem(lib.aec_kalman_smem(block, cfg.n_blocks), dev, what)
        entry = lib.aec_kalman_batched_spectra if spectra_in else lib.aec_kalman_batched
        err = entry(*head, *stage1_operands(cfg, dev, block), dev.index, _build.stream_of(x))
    else:
        _build.check_smem(lib.aec_kalman_fft_smem(block, cfg.n_blocks), dev, what)
        ops = fft_operands(cfg, dev, block)  # spectra_in goes between the plan and the constants
        err = lib.aec_kalman_batched_fft(*head, *ops[:5], int(spectra_in), *ops[5:], dev.index,
                                         _build.stream_of(x))
    _build.check(err, "kalman_batched")
    return step


def check_inputs(cfg, far: torch.Tensor, mic: torch.Tensor, block: int, ndim: int) -> None:
    """Raise unless far/mic are what a stage-1 kernel takes: one CUDA
    device, float32, contiguous, ``ndim`` axes of one shape, a block and a
    partition count of at least 1."""
    if far.device != mic.device or far.device.type != "cuda":
        raise ValueError(f"far/mic must be on one CUDA device, got {far.device}, {mic.device}")
    if far.dtype != torch.float32 or mic.dtype != torch.float32:
        raise TypeError(f"far/mic must be float32, got {far.dtype}, {mic.dtype}")
    if far.ndim != ndim or far.shape != mic.shape:
        shape = "[batch, n]" if ndim == 2 else "[n]"
        raise ValueError(f"far/mic must be {shape} of one shape, got {far.shape}, {mic.shape}")
    if not (far.is_contiguous() and mic.is_contiguous()):
        raise ValueError("far/mic must be contiguous")
    if block < 1 or cfg.n_blocks < 1:
        raise ValueError(f"block and n_blocks must be >= 1, got {block}, {cfg.n_blocks}")


def launch_single(cfg, far: torch.Tensor, mic: torch.Tensor, block: int,
                  lib: ctypes.CDLL | None = None) -> tuple[torch.Tensor, str]:
    """One utterance through K6 (a ``KalmanConfig``) or K7 (an ``NlmsConfig``)
    -> (e [n], the step that ran): the FFT route on one CTA where
    :func:`step_for` says ``"fft"``, else the dense route on one cluster.
    Raises if a CTA cannot hold its layout, or if the card cannot place the
    cluster. ``lib`` is another build of the source (``single_costs``)."""
    check_inputs(cfg, far, mic, block, 1)
    lib, dev = lib or single_stream_lib(), far.device
    nlms = isinstance(cfg, NlmsConfig)
    what = f"the single-stream {'NLMS' if nlms else 'Kalman'} kernel"
    n = mic.shape[-1]
    farp, micp = ols.pad_to_blocks(far, block), ols.pad_to_blocks(mic, block)
    e = torch.empty_like(micp)
    head = (_build.ptr(farp), _build.ptr(micp), _build.ptr(e), farp.shape[0] // block)
    step = step_for(block)
    if step == "fft":
        _build.check_smem(lib.aec_single_fft_smem(block, cfg.n_blocks, int(nlms)), dev, what)
        entry = lib.aec_nlms_single_fft if nlms else lib.aec_kalman_single_fft
        operands = fft_operands(cfg, dev, block)
    else:
        _build.check_smem(lib.aec_single_smem(block, cfg.n_blocks, int(nlms)), dev,
                          f"{what}'s dense route (one CTA of {lib.aec_single_cluster()})")
        entry = lib.aec_nlms_single if nlms else lib.aec_kalman_single
        operands = stage1_operands(cfg, dev, block)
    _build.check(entry(*head, *operands, dev.index, _build.stream_of(far)), "single_stream")
    return e[:n], step


def kalman_cancel_fused_batched(
    cfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [batch, n] -> {"wav": echo-cancelled [batch, n]} on K1.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain loop. ``n`` is zero-padded to a block multiple and the output is
    cut back to ``n``. ``steps`` counts the launches of the FFT step and of
    the dense step (a block with a prime factor other than 2, 3, 5).
    """
    if far.device.type == "cpu":
        return {"wav": kalman_cancel_plain(cfg, far, mic, block=block)["wav"]}
    check_inputs(cfg, far, mic, block, 2)
    n = mic.shape[-1]
    farp, micp = ols.pad_to_blocks(far, block), ols.pad_to_blocks(mic, block)
    e = torch.empty_like(micp)
    kalman_cancel_fused_batched.steps[launch_batched(cfg, farp, micp, e, block, False)] += 1
    kalman_cancel_fused_batched.launches += 1
    return {"wav": e[:, :n]}


kalman_cancel_fused_batched.launches = 0
kalman_cancel_fused_batched.steps = {"fft": 0, "dense": 0}


def kalman_cancel_fused(
    cfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor, *, block: int = 256,
) -> dict[str, torch.Tensor]:
    """far/mic [n] -> {"wav": echo-cancelled [n]} on K6.

    A CUDA tensor launches the kernel (or raises, also when the card cannot
    place the dense route's cluster); a CPU tensor takes the plain loop.
    ``steps`` counts the launches of the FFT route (one CTA) and of the
    dense route (one cluster; a block with a prime factor other than 2, 3,
    5).
    """
    if far.device.type == "cpu":
        return {"wav": kalman_cancel_plain(cfg, far, mic, block=block)["wav"]}
    e, step = launch_single(cfg, far, mic, block)
    kalman_cancel_fused.steps[step] += 1
    kalman_cancel_fused.launches += 1
    return {"wav": e}


kalman_cancel_fused.launches = 0
kalman_cancel_fused.steps = {"fft": 0, "dense": 0}


def kalman_filter_fused_batched_plain(
    cfg: KalmanConfig, x_ri: torch.Tensor, d_blocks: torch.Tensor, *, block: int = 256,
) -> torch.Tensor:
    """Plain version of K12: the block loop of ``linear/kalman.py`` on the
    spectra, (B, T, 2K) and (B, T, block) -> e-blocks (B, T, block)."""
    return kalman_filter(cfg, x_ri, d_blocks, block=block)[0]


def kalman_filter_fused_batched(
    cfg: KalmanConfig, x_ri: torch.Tensor, d_blocks: torch.Tensor, *, block: int = 256,
) -> torch.Tensor:
    """Far-frame spectra ``x_ri`` (B, T, 2K) [re || im] and mic blocks
    ``d_blocks`` (B, T, block) -> echo-cancelled blocks (B, T, block) on K12.

    The filter-level entry point of JAX's ``kalman_filter_fused_batched``;
    its waveform wrapper, JAX's ``kalman_cancel_fused_batched``, has the same
    semantics as the ``_bl`` one and is :func:`kalman_cancel_fused_batched`
    here. A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    the plain loop. Limits and ``steps`` as K1's: fp32, contiguous, the
    shared memory of one CTA.
    """
    if x_ri.device.type == "cpu":
        return kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks, block=block)
    if d_blocks.device != x_ri.device or x_ri.device.type != "cuda":
        raise ValueError(
            f"x_ri/d_blocks must be on one CUDA device, got {x_ri.device}, {d_blocks.device}"
        )
    if x_ri.dtype != torch.float32 or d_blocks.dtype != torch.float32:
        raise TypeError(f"x_ri/d_blocks must be float32, got {x_ri.dtype}, {d_blocks.dtype}")
    if (x_ri.ndim != 3 or d_blocks.shape != (*x_ri.shape[:2], block)
            or x_ri.shape[-1] != 2 * (block + 1)):
        raise ValueError(
            f"x_ri must be (B, T, {2 * (block + 1)}) and d_blocks (B, T, {block}), got "
            f"{tuple(x_ri.shape)}, {tuple(d_blocks.shape)}"
        )
    if not (x_ri.is_contiguous() and d_blocks.is_contiguous()):
        raise ValueError("x_ri/d_blocks must be contiguous")
    if block < 1 or cfg.n_blocks < 1:
        raise ValueError(f"block and n_blocks must be >= 1, got {block}, {cfg.n_blocks}")
    e = torch.empty_like(d_blocks)
    kalman_filter_fused_batched.steps[launch_batched(cfg, x_ri, d_blocks, e, block, True)] += 1
    kalman_filter_fused_batched.launches += 1
    return e


kalman_filter_fused_batched.launches = 0
kalman_filter_fused_batched.steps = {"fft": 0, "dense": 0}
