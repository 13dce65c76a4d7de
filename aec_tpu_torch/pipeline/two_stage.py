"""Two-stage AEC composition: Kalman stage 1 -> LittleNet stage 2
(counterpart of ``aec_tpu/pipeline/two_stage.py``).

Routing follows the JAX package, decided by the tensors' device:

- Batched CUDA calls with ``quality="fast"``, Kalman stage 1,
  ``normalize=False``, a width-1 LittleNet, ``n % hop == 0`` and the
  2x-overlap STFT geometry: the whole pipeline on kernel K4
  (``kernels/two_stage.py``), as JAX sends them to ``two_stage_fused``.
- Other CUDA calls with a width-1 LittleNet, ``n % hop == 0`` and the
  2x-overlap geometry (the legacy ``fast=True`` among them): stage 1 on
  kernel K1 (``kernels/kalman.py``), stage 2 on kernel K2
  (``kernels/stage2.py``). A 1-D input runs as a batch of one.
- Wider checkpoints (GRU hidden != ERB bands), hop-fractional lengths and
  other STFT geometries take the offline ``models.little_net_apply`` for
  stage 2, as the JAX package routes them off its stage-2 kernel.
- CPU tensors: the plain versions of both stages.
"""

from __future__ import annotations

import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.models.little_net import LittleNet, little_net_apply


def _route_single_kernel(
    *, on_cuda: bool, stage1: str, lin_cfg, fast_legacy: bool, quality: str,
    normalize: bool, scfg: StftConfig, n: int,
) -> bool:
    """True when the whole pipeline runs as the one kernel K4: the guards of
    ``aec_tpu/pipeline/two_stage.py:_route_single_kernel``, with "the TPU
    backend" read as "tensors on CUDA". The legacy ``fast=True`` keeps the
    two-kernel composition, as in JAX."""
    return (
        on_cuda
        and quality == "fast"
        and not fast_legacy
        and stage1 == "kalman"
        and (lin_cfg is None or isinstance(lin_cfg, KalmanConfig))
        and not normalize
        and n % scfg.hop == 0
        and scfg.win_len == 2 * scfg.hop
        and scfg.fft_len == scfg.win_len
    )


@torch.no_grad()
def two_stage_cancel(
    params: LittleNet,
    far: torch.Tensor,
    mic: torch.Tensor,
    erb,
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | None = None,
    scfg: StftConfig = StftConfig(),
    normalize: bool = False,
    fast: bool = False,
    quality: str = "parity",
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """far/mic wav [n] or [B, n] -> ``{"wav", "linear_wav", "mask"}``.

    ``params`` is a :class:`LittleNet` on the inputs' device; ``erb`` the
    (K, E) filterbank (a numpy array is moved to the inputs' device).
    ``normalize`` applies LittleNet's global pseudo-norm to its inputs;
    ``gain_norm`` the scale-sane ERB synthesis (see ``little_net_apply``).

    Every product runs in plain fp32 at either ``quality``: ``"parity"``
    and ``"fast"`` (and the legacy ``fast=True``) compute the same numbers
    and differ only in the route (see the module docstring). JAX's
    ``stage2_precision`` (a ``jax.lax.Precision`` knob for the TPU's bf16
    matrix unit) has no meaning here and is left out. ``stage1="nlms"``
    raises ``NotImplementedError`` until NLMS is ported (ROADMAP.md A3b,
    B4).
    """
    if quality not in ("parity", "fast"):
        raise ValueError(f"quality must be 'parity' or 'fast', got {quality!r}")
    if stage1 == "nlms":
        raise NotImplementedError(
            "stage1='nlms' is not ported yet (ROADMAP.md A3b: linear/nlms, "
            "B4: pallas_nlms)"
        )
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    std_width = params.hidden == erb.shape[-1]
    if far.ndim == 2 and std_width and _route_single_kernel(
        on_cuda=far.is_cuda, stage1=stage1, lin_cfg=lin_cfg, fast_legacy=fast,
        quality=quality, normalize=normalize, scfg=scfg, n=far.shape[-1],
    ):
        from aec_tpu_torch.kernels.two_stage import two_stage_fused

        return two_stage_fused(params, far, mic, erb, kcfg=lin_cfg or KalmanConfig(),
                               scfg=scfg, gain_norm=gain_norm)
    if stage1 == "kalman":
        lin_cfg = lin_cfg or KalmanConfig()
        if not isinstance(lin_cfg, KalmanConfig):
            raise TypeError(f"stage1='kalman' needs a KalmanConfig, got {lin_cfg!r}")
        linear_wav = kalman_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
    elif stage1 == "none":
        linear_wav = mic
    else:
        raise ValueError(f"stage1 must be 'kalman', 'nlms' or 'none', got {stage1!r}")

    batched = linear_wav.ndim == 2
    lw = linear_wav if batched else linear_wav[None]
    fw = far if batched else far[None]
    if (
        lw.is_cuda
        and std_width
        and lw.shape[-1] % scfg.hop == 0
        and scfg.win_len == 2 * scfg.hop
        and scfg.fft_len == scfg.win_len
    ):
        from aec_tpu_torch.kernels.stage2 import little_net_apply_fused_wav

        out = little_net_apply_fused_wav(
            params, lw, fw, erb, scfg, normalize=normalize, gain_norm=gain_norm
        )
    else:
        out = little_net_apply(
            params, lw, fw, erb, scfg, normalize=normalize, gain_norm=gain_norm
        )
    wav, mask = out["wav"], out["mask"]
    if not batched:
        wav, mask = wav[0], mask[0]
    return {"wav": wav, "linear_wav": linear_wav, "mask": mask}
