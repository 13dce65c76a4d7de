"""Streaming (frame-in / frame-out) two-stage AEC runtime
(counterpart of ``aec_tpu/pipeline/streaming.py``).

The offline stage-2 path pads the signal by ``hop`` on both sides, so
analysis frame t covers input blocks [t-1, t] and output block t needs
synthesis frames t and t+1 (the OLA envelope is exactly periodic in the
trimmed interior). A streaming step therefore:

1. runs stage 1 (Kalman, causal by construction) on the new 256-sample block;
2. forms analysis frame t = [prev_block || cur_block];
3. advances the GRU one step and applies the ERB mask;
4. emits output block t-1 = (tail(s_{t-1}) + head(s_t)) / env_period;

carrying {stage-1 state, previous blocks, GRU h, synthesis tail}. Latency
is one block (hop/sr = 16 ms). ``stream_flush`` feeds the implicit trailing
zero block and emits the final output block, which makes stream == offline
to fp32 round-off for any chunking.

The reference's global mean/std pseudo-norm is not causal. ``normalize=
False`` (default) streams the un-normalized path, equal to the offline
``normalize=False``; ``normalize=True`` subtracts a CAUSAL running scalar,
re-estimated from all samples seen so far (per stream, per branch), which
converges to the offline global one.

A state is a dict of tensors with the JAX leaf names; the batched functions
carry a leading stream axis on every leaf and run natively batched (no
vmap). Everything here is plain torch on the inputs' device, as the JAX
package runs this module as XLA: it is the plain version that the serving
kernel K3 (``kernels/serving.py``) is held against. ``quality="parity"``
and ``"fast"`` both compute in fp32 (JAX's "fast" was the TPU's mixed bf16
tier, which the port does not have); NLMS has no mixed tier in JAX
either. ``stage1`` is "kalman", "nlms" or "none".
"""

from __future__ import annotations

import functools
from typing import Any, TypedDict

import numpy as np
import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.stft import (
    StftConfig,
    analysis_matrix,
    magnitude,
    split_complex,
    synthesis_matrix,
)
from aec_tpu_torch.dsp.windows import periodic_window
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.kalman import kalman_init, kalman_step
from aec_tpu_torch.linear.nlms import nlms_init, nlms_step
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.ops.gru import gru_cell


class StreamState(TypedDict):
    stage1: Any  # Kalman or NLMS state dict, or {} for stage1="none"
    prev_lin: torch.Tensor  # (hop,) previous stage-1 output block
    prev_far: torch.Tensor  # (hop,) previous far-end block
    gru_h: torch.Tensor  # (1, E)
    syn_tail: torch.Tensor  # (hop,) second half of the previous synthesis frame
    # running moments of the causal pseudo-norm (count, then sum / sumsq per
    # branch); carried always, consumed when normalize=True
    norm: dict[str, torch.Tensor]


_NORM_KEYS = ("count", "sum_lin", "sumsq_lin", "sum_far", "sumsq_far")


def _check_stage1(stage1: str) -> None:
    if stage1 not in ("kalman", "nlms", "none"):
        raise ValueError(f"stage1 must be 'kalman', 'nlms' or 'none', got {stage1!r}")


def _check_quality(quality: str) -> None:
    if quality not in ("parity", "fast"):
        raise ValueError(f"quality must be 'parity' or 'fast', got {quality!r}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _env_period(cfg: StftConfig) -> np.ndarray:
    """Interior OLA envelope, periodic with period hop (win = 2*hop)."""
    w2 = periodic_window(cfg.win_type, cfg.win_len) ** 2
    return w2[: cfg.hop] + w2[cfg.hop :]


@functools.lru_cache(maxsize=8)
def _env_den(cfg: StftConfig, device: torch.device) -> torch.Tensor:
    """``env + 1e-8`` in fp32, the divisor of every emitted block."""
    return torch.as_tensor(_env_period(cfg), dtype=torch.float32, device=device) + 1e-8


def stream_init(
    erb_bands: int = 32,
    cfg: StftConfig = StftConfig(),
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | NlmsConfig | None = None,
    device="cuda",
) -> StreamState:
    """Zero state of one stream on ``device`` (the card unless the caller
    asks for ``device="cpu"``); ``lin_cfg`` is the stage-1 filter's config
    (None: that filter's defaults)."""
    _check_stage1(stage1)
    if stage1 == "kalman":
        s1 = kalman_init(lin_cfg or KalmanConfig(), cfg.n_freqs, device=device)
    elif stage1 == "nlms":
        s1 = nlms_init(lin_cfg or NlmsConfig(), cfg.n_freqs, device=device)
    else:
        s1 = {}
    return StreamState(
        stage1=s1,
        prev_lin=torch.zeros(cfg.hop, device=device),
        prev_far=torch.zeros(cfg.hop, device=device),
        gru_h=torch.zeros(1, erb_bands, device=device),
        syn_tail=torch.zeros(cfg.hop, device=device),
        norm={k: torch.zeros((), device=device) for k in _NORM_KEYS},
    )


def _stage2_frame(
    net: LittleNet,
    lin_frame: torch.Tensor,  # (S, win) stage-1 output samples for this frame
    far_frame: torch.Tensor,  # (S, win)
    gru_h: torch.Tensor,  # (S, 1, E)
    erb: torch.Tensor,
    cfg: StftConfig,
    gain_norm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis frame per stream through LittleNet -> (syn_frame
    (S, win), new_h (S, 1, E)). ``gain_norm`` divides the gain by the
    unmasked back-projection (``little_net_apply``)."""
    a = analysis_matrix(cfg, device=lin_frame.device, dtype=lin_frame.dtype)
    spec = lin_frame @ a  # (S, 2K)
    mic_erb = magnitude(spec) @ erb  # (S, E)
    ref_erb = magnitude(far_frame @ a) @ erb
    feats = torch.cat([mic_erb, torch.abs(mic_erb - ref_erb)], -1)
    gp = net.gru_params()
    h = gru_cell(gp, gru_h[:, 0], feats @ gp["w_ih"].T + gp["b_ih"])  # (S, E)
    hid = torch.relu(net.linear1(torch.cat([h, mic_erb], -1)))
    mask = torch.sigmoid(net.linear2(hid))
    gain = (mask * mic_erb) @ erb.T  # (S, K)
    if gain_norm:
        gain = gain / (mic_erb @ erb.T + 1e-9)
    re, im = split_complex(spec)
    syn = torch.cat([gain * re, gain * im], -1) @ synthesis_matrix(
        cfg, device=spec.device, dtype=spec.dtype
    )
    return syn, h[:, None, :]


def _norm_scalar(total: torch.Tensor, sumsq: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Running mean/std ratio (torch-unbiased std, the reference's
    pseudo-norm semantics)."""
    mean = total / count
    var = (sumsq - count * mean * mean) / torch.clamp_min(count - 1.0, 1.0)
    return mean / torch.sqrt(torch.clamp_min(var, 1e-12))


def _stream_step_core(
    net: LittleNet,
    state: StreamState,  # leading stream axis on every leaf
    far_block: torch.Tensor,  # (S, hop)
    mic_block: torch.Tensor,  # (S, hop)
    erb: torch.Tensor,
    cfg: StftConfig,
    stage1: str,
    lin_cfg: KalmanConfig | NlmsConfig | None,
    normalize: bool = False,
    gain_norm: bool = False,
) -> tuple[StreamState, torch.Tensor]:
    if stage1 in ("kalman", "nlms"):
        x_t = ols.frame_to_spectrum(torch.cat([state["prev_far"], far_block], -1), cfg.hop)
        step, default = (kalman_step, KalmanConfig) if stage1 == "kalman" else (
            nlms_step, NlmsConfig)
        s1, lin_block = step(
            lin_cfg or default(), state["stage1"], x_t, mic_block, block=cfg.hop
        )
    else:
        s1, lin_block = state["stage1"], mic_block

    # stage 2: frame t = [prev_lin || lin_block]
    lin_frame = torch.cat([state["prev_lin"], lin_block], -1)
    far_frame = torch.cat([state["prev_far"], far_block], -1)
    norm = state["norm"]
    if normalize:
        # causal pseudo-norm: fold the new block into the running moments,
        # subtract the CURRENT mean/std scalar from the whole frame
        count = norm["count"] + cfg.hop
        norm = {
            "count": count,
            "sum_lin": norm["sum_lin"] + torch.sum(lin_block, -1),
            "sumsq_lin": norm["sumsq_lin"] + torch.sum(lin_block * lin_block, -1),
            "sum_far": norm["sum_far"] + torch.sum(far_block, -1),
            "sumsq_far": norm["sumsq_far"] + torch.sum(far_block * far_block, -1),
        }
        lin_frame = lin_frame - _norm_scalar(norm["sum_lin"], norm["sumsq_lin"], count)[:, None]
        far_frame = far_frame - _norm_scalar(norm["sum_far"], norm["sumsq_far"], count)[:, None]
    syn, h = _stage2_frame(net, lin_frame, far_frame, state["gru_h"], erb, cfg, gain_norm)
    out_block = (state["syn_tail"] + syn[:, : cfg.hop]) / _env_den(cfg, syn.device) + 1e-9
    new_state = StreamState(
        stage1=s1, prev_lin=lin_block, prev_far=far_block, gru_h=h,
        syn_tail=syn[:, cfg.hop :], norm=norm,
    )
    return new_state, out_block


def _erb_on(erb, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(erb, dtype=torch.float32, device=like.device)


@torch.no_grad()
def stream_step_batched(
    net: LittleNet,
    state: StreamState,  # leading stream axis on every leaf
    far_block: torch.Tensor,  # (S, hop)
    mic_block: torch.Tensor,  # (S, hop)
    erb,
    cfg: StftConfig = StftConfig(),
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | NlmsConfig | None = None,
    normalize: bool = False,
    quality: str = "parity",
    gain_norm: bool = False,
) -> tuple[StreamState, torch.Tensor]:
    """One 16 ms hop for many concurrent streams -> (new state, out (S, hop)).

    Every per-stream filter state, GRU state and OLA tail advances in
    parallel. The emitted block lags the input by one hop; the first one is
    the offline path's trimmed left edge."""
    _check_stage1(stage1)
    _check_quality(quality)
    return _stream_step_core(
        net, state, far_block, mic_block, _erb_on(erb, far_block), cfg, stage1, lin_cfg,
        normalize, gain_norm,
    )


def stream_step(
    net: LittleNet,
    state: StreamState,
    far_block: torch.Tensor,  # (hop,)
    mic_block: torch.Tensor,  # (hop,)
    erb,
    cfg: StftConfig = StftConfig(),
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | NlmsConfig | None = None,
    normalize: bool = False,
    quality: str = "parity",
    gain_norm: bool = False,
) -> tuple[StreamState, torch.Tensor]:
    """Consume one hop of far/mic; emit one hop of enhanced audio.

    The emitted block lags the input by one hop (16 ms). The VERY FIRST
    emitted block is the offline path's trimmed left edge and must be
    discarded by the caller (see :func:`stream_run`). Runs as a batch of
    one through :func:`stream_step_batched`."""
    new_state, out = stream_step_batched(
        net, _tree_map(lambda a: a[None], state), far_block[None], mic_block[None], erb, cfg,
        stage1=stage1, lin_cfg=lin_cfg, normalize=normalize, quality=quality,
        gain_norm=gain_norm,
    )
    return _tree_map(lambda a: a[0], new_state), out[0]


@torch.no_grad()
def stream_flush(
    net: LittleNet,
    state: StreamState,
    erb,
    cfg: StftConfig = StftConfig(),
    *,
    normalize: bool = False,
    gain_norm: bool = False,
) -> torch.Tensor:
    """End of stream: process the implicit trailing zero block (the offline
    path's right pad) and emit the final output block, (hop,) for one
    stream's state or (S, hop) for a batched state."""
    batched = state["prev_lin"].ndim == 2
    st = state if batched else _tree_map(lambda a: a[None], state)
    prev_lin, prev_far = st["prev_lin"], st["prev_far"]
    if normalize:
        # the offline pad is appended AFTER normalization: subtract the final
        # running scalar from the data half only
        n = st["norm"]
        prev_lin = prev_lin - _norm_scalar(n["sum_lin"], n["sumsq_lin"], n["count"])[:, None]
        prev_far = prev_far - _norm_scalar(n["sum_far"], n["sumsq_far"], n["count"])[:, None]
    zero = torch.zeros_like(prev_lin)
    syn, _ = _stage2_frame(
        net, torch.cat([prev_lin, zero], -1), torch.cat([prev_far, zero], -1), st["gru_h"],
        _erb_on(erb, prev_lin), cfg, gain_norm,
    )
    out = (st["syn_tail"] + syn[:, : cfg.hop]) / _env_den(cfg, syn.device) + 1e-9
    return out if batched else out[0]


def stream_init_batched(
    n_streams: int,
    erb_bands: int = 32,
    cfg: StftConfig = StftConfig(),
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | NlmsConfig | None = None,
    device="cuda",
) -> StreamState:
    """State for ``n_streams`` concurrent calls (leading axis = stream) on
    ``device`` (the card unless the caller asks for ``device="cpu"``)."""
    one = stream_init(erb_bands, cfg, stage1=stage1, lin_cfg=lin_cfg, device=device)
    return _tree_map(lambda a: a.expand(n_streams, *a.shape).clone(), one)


def stream_run(
    net: LittleNet,
    far,
    mic,
    erb,
    cfg: StftConfig = StftConfig(),
    *,
    stage1: str = "kalman",
    lin_cfg: KalmanConfig | NlmsConfig | None = None,
    erb_bands: int = 32,
    normalize: bool = False,
    quality: str = "parity",
    gain_norm: bool = False,
) -> torch.Tensor:
    """Run a whole utterance hop by hop: far/mic (n,) with n % hop == 0 ->
    enhanced (n,) on far's device (arrays go to the CPU)."""
    far, mic = torch.as_tensor(far), torch.as_tensor(mic)
    if far.shape[-1] % cfg.hop:
        raise ValueError(f"stream_run needs a hop multiple, got {far.shape[-1]} samples")
    erb = _erb_on(erb, far)
    state = stream_init(erb_bands, cfg, stage1=stage1, lin_cfg=lin_cfg, device=far.device)
    outs = []
    for lo in range(0, far.shape[-1], cfg.hop):
        state, out = stream_step(
            net, state, far[lo : lo + cfg.hop], mic[lo : lo + cfg.hop], erb, cfg,
            stage1=stage1, lin_cfg=lin_cfg, normalize=normalize, quality=quality,
            gain_norm=gain_norm,
        )
        outs.append(out)
    outs.append(stream_flush(net, state, erb, cfg, normalize=normalize, gain_norm=gain_norm))
    # the first emitted block is the offline path's trimmed left edge: drop it
    return torch.cat(outs)[cfg.hop :]
