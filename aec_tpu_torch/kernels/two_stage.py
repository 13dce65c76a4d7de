"""Kernel K4: the whole two-stage pipeline (Kalman + LittleNet) as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_two_stage.py:134`` (``two_stage_fused``,
``pallas_call`` at ``:209``), the route of ``two_stage_cancel``'s batched
``quality="fast"`` calls. The kernel is ``csrc/two_stage.cu`` on the
two-stage hop of ``csrc/hop.cuh``, K3's: one CTA per utterance walks T + 1
steps with both stages' state in shared memory, each step K1's Kalman FFT
step and one LittleNet frame on the same FFTs, and the stage-1 block
reaches stage 2 in shared memory (device memory sees it only as the
``linear_wav`` output). A hop with a prime factor other than 2, 3 and 5
runs the dense hop; ``steps`` counts which ran. The launch's constants are
prepared once and cached (:func:`kernels.hop.prepare`); the source's header
has the reckoning.

:func:`two_stage_fused_plain` is its plain version: the K1-plain then
K2-plain composition, which is what the JAX package holds its kernel
against; :func:`two_stage_fused_modeled` a plain-torch model of the
kernel's FFT route for the CPU tests. ``normalize=False`` only, as in JAX:
the offline pseudo-norm needs the whole stage-1 output before stage 2
starts. The JAX wrapper's TPU knobs (``tile``, ``interpret``, ``dot_mode``,
``vmem_limit_mb``, ``unroll``) have no meaning here and are left out; every
product is plain fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import _build, hop
from aec_tpu_torch.kernels.stage2 import little_net_apply_fused_plain
from aec_tpu_torch.linear.kalman import kalman_cancel_plain
from aec_tpu_torch.models.little_net import LittleNet


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("two_stage")
    p, i = ctypes.c_void_p, ctypes.c_int
    # the prepared constants, far, mic, out, lin, mask, the batch and
    # blocks, gain_norm, the device and the stream
    lib.aec_two_stage.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.aec_two_stage.restype = ctypes.c_int
    lib.aec_two_stage_smem.argtypes = [i, i, i, i]
    lib.aec_two_stage_smem.restype = ctypes.c_longlong
    hop.check_consts(lib)
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
    (B, n / hop + 1, E)}, in the inputs' dtype (a float64 net and inputs
    give the fp64 evaluation the kernel's round-off is measured against)."""
    t_blocks = _t_blocks(far, mic, scfg)
    lin = kalman_cancel_plain(kcfg, far, mic, block=scfg.hop)["wav"]
    b = far.shape[0]
    out, mask = little_net_apply_fused_plain(
        net, lin.reshape(b, t_blocks, scfg.hop), far.reshape(b, t_blocks, scfg.hop),
        torch.as_tensor(erb, dtype=far.dtype, device=far.device), scfg,
        gain_norm=gain_norm,
    )
    return {"wav": out.reshape(b, -1), "linear_wav": lin, "mask": mask}


@torch.no_grad()
def two_stage_fused_modeled(
    net: LittleNet, far: torch.Tensor, mic: torch.Tensor, erb: torch.Tensor, *,
    kcfg: KalmanConfig = KalmanConfig(), scfg: StftConfig = StftConfig(),
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """A plain-torch model of K4's FFT route for the CPU tests, with
    :func:`two_stage_fused_plain`'s signature: T hops of
    :func:`kernels.hop.hop_model` from the initial state (W = 0, P = init_p
    predicted), then the zero flush frame."""
    t_blocks, h = _t_blocks(far, mic, scfg), scfg.hop
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    b, k, L, e_bands = far.shape[0], h + 1, kcfg.n_blocks, erb.shape[-1]
    z = far.new_zeros
    s = {"wr": z((b, L, k)), "wi": z((b, L, k)), "p": far.new_full((b, L, k), kcfg.init_p),
         "xr": z((b, L, k)), "xi": z((b, L, k)), "psi": far.new_full((b, k), kcfg.psi_floor),
         "frame": z((b, 2 * h)), "lin": z((b, 2 * h)), "far": z((b, 2 * h)),
         "h": z((b, e_bands)), "tail": z((b, h))}
    hop.predict_model(kcfg, s, s["wr"], s["wi"])
    wav, lin = torch.empty_like(far), torch.empty_like(far)
    mask = far.new_empty((b, t_blocks + 1, e_bands))
    for t in range(t_blocks + 1):
        blk = slice(t * h, (t + 1) * h)
        if t < t_blocks:
            s["frame"] = torch.cat([s["frame"][:, :h], far[:, blk]], -1)
            s["e"] = mic[:, blk]
            out, mask[:, t] = hop.hop_model(net, kcfg, s, t, erb, scfg, gain_norm, False, False,
                                            False)
            lin[:, blk] = s["e"]
        else:  # the zero flush frame
            for key in ("lin", "far"):
                s[key] = torch.cat([s[key][:, :h], z((b, h))], -1)
            out, mask[:, t] = hop.frame_model(net, s, erb, scfg, gain_norm, 0.0, 0.0)
        if t:
            wav[:, (t - 1) * h:t * h] = out
    return {"wav": wav, "linear_wav": lin, "mask": mask}


def _check(far: torch.Tensor, mic: torch.Tensor) -> None:
    if far.device.type != "cuda" or mic.device != far.device:
        raise ValueError(f"far/mic must be on one CUDA device, got {far.device}, {mic.device}")
    if far.dtype != torch.float32 or mic.dtype != torch.float32:
        raise TypeError(f"far/mic must be float32, got {far.dtype}, {mic.dtype}")
    if not (far.is_contiguous() and mic.is_contiguous()):
        raise ValueError("far/mic must be contiguous")


def two_stage_fused(
    net: LittleNet, far: torch.Tensor, mic: torch.Tensor, erb: torch.Tensor, *,
    kcfg: KalmanConfig = KalmanConfig(), scfg: StftConfig = StftConfig(),
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """Full two-stage AEC in one launch: far/mic (B, n), n % hop == 0 ->
    {"wav": (B, n), "linear_wav": (B, n), "mask": (B, n / hop + 1, E)}.

    A CUDA tensor launches K4 (or raises); a CPU tensor takes
    :func:`two_stage_fused_plain`. ``steps`` counts the launches on FFTs and
    on the dense hop."""
    if far.device.type == "cpu":
        return two_stage_fused_plain(net, far, mic, erb, kcfg=kcfg, scfg=scfg,
                                     gain_norm=gain_norm)
    t_blocks = _t_blocks(far, mic, scfg)
    _check(far, mic)
    dev = far.device
    erb = torch.as_tensor(erb, dtype=torch.float32, device=dev)
    lib = _lib()
    bands = erb.shape[-1]
    prep = hop.prepare(
        net, erb, kcfg, scfg, dev,
        lambda fft: lib.aec_two_stage_smem(scfg.hop, kcfg.n_blocks, bands, int(fft)),
        "the two-stage kernel")
    b = far.shape[0]
    out, lin = torch.empty_like(far), torch.empty_like(far)
    mask = far.new_empty((b, t_blocks + 1, bands))
    err = lib.aec_two_stage(
        prep.ref, far.data_ptr(), mic.data_ptr(), out.data_ptr(), lin.data_ptr(),
        mask.data_ptr(), b, t_blocks, int(gain_norm), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "two_stage")
    two_stage_fused.steps[prep.step] += 1
    two_stage_fused.launches += 1
    return {"wav": out, "linear_wav": lin, "mask": mask}


two_stage_fused.launches = 0
two_stage_fused.steps = {"fft": 0, "dense": 0}
