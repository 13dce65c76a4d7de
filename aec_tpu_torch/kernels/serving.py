"""Kernel K3: the two-stage serving step for S live streams, as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_serving.py:239`` (``serving_step_fused``,
``pallas_call`` at ``:320``). The serving hot loop advances S live calls by
k >= 1 hops of 16 ms per call: per stream and hop one stage-1 block update
(Kalman or NLMS, ``stage1``), its cancelled block handed to one LittleNet
frame, with the one-hop output lag of ``pipeline/streaming``. The kernel is
``csrc/serving.cu`` on ``two_stage_block_step`` of ``csrc/bl_common.cuh``,
one template over the filter: one CTA per stream loads the stream's state
(~56 KB with Kalman, ~47 KB with NLMS) into shared memory, runs the k hops,
and writes the state back in place. It is bound by each SM's L2 read rate
of the DFT bases, not by the state round trip; the source's header has the
reckoning and the levers left.

``ServingState`` keeps the JAX leaf names in a per-stream contiguous
layout (the JAX layout put streams in TPU lanes): ``wr, wi, xbr, xbi`` are
(S, L, K), the far-spectrum ring in age order (``[:, l]`` is l blocks old,
as ``StreamState``'s ``x_buf``); ``p`` is the Kalman covariance (S, L, K)
or NLMS's smoothed far power (S, K), as in JAX; ``psi`` is (S, K);
``fprev``, ``tail``, ``prev_lin``, ``prev_far`` are (S, hop), ``h`` is
(S, E) and ``nm`` is (S, 8): rows 0-4 the causal pseudo-norm's running
moments (count, sum and sum of squares of the stage-1 output, then of the
far end), rows 5-6 the health monitor's EMAs of mic and stage-1-residual
block power, row 7 pad.
So the migrations to and from ``StreamState`` are copies and exact
inverses.

:func:`serving_step_plain` is K3's plain version (``pipeline/streaming``'s
step plus the monitor rows), which :func:`serving_step_fused` takes for CPU
tensors only. The JAX wrapper's TPU knobs (``tile``, ``interpret``,
``dot_mode``, ``vmem_limit_mb``) have no meaning here and are left out:
every product is plain fp32, the JAX ``dot_mode="high"`` grade.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.kalman import KALMAN_ARGTYPES, kalman_operands
from aec_tpu_torch.kernels.nlms import nlms_operands
from aec_tpu_torch.kernels.stage2 import STAGE2_ARGTYPES, check_net, stage2_operands
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.pipeline.streaming import _check_stage1, _stream_step_core

ServingState = dict[str, torch.Tensor]

_KEYS = ("wr", "wi", "p", "xbr", "xbi", "psi", "fprev", "h", "tail", "prev_lin",
         "prev_far", "nm")
_NM_ROWS = 8

# per-block EMA coefficient of the serving health monitor (16 ms blocks ->
# ~1.6 s time constant), as the JAX package
MONITOR_SMOOTH = 0.99


def _check_serving_stage1(stage1: str) -> None:
    _check_stage1(stage1)
    if stage1 == "none":
        raise ValueError(
            "the serving state carries a stage-1 filter: stage1 must be 'kalman' or 'nlms'"
        )


def _filter_cfg(kcfg, stage1: str):
    """``kcfg``, or the stage-1 filter's default config."""
    return kcfg or (KalmanConfig() if stage1 == "kalman" else NlmsConfig())


def _init_values(kcfg, stage1: str) -> dict[str, float]:
    """The :func:`serving_init` values of the leaves that do not start at 0."""
    if stage1 == "kalman":
        return {"p": kcfg.init_p, "psi": kcfg.psi_floor}
    return {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("serving")
    p, i = ctypes.c_void_p, ctypes.c_int
    # Kalman and NLMS take the same arguments (eight filter constants each):
    # streams and blocks, the stage-1 geometry, the bands, the stage-1 and
    # stage-2 operands
    for fn in (lib.aec_serving, lib.aec_serving_nlms):
        fn.argtypes = [
            p, p, p, *[p] * len(_KEYS), i, i, *KALMAN_ARGTYPES[:2], i, *KALMAN_ARGTYPES[2:],
            *STAGE2_ARGTYPES, i, i, i, p,
        ]
        fn.restype = ctypes.c_int
    lib.aec_serving_smem.argtypes = [i, i, i, i]
    lib.aec_serving_smem.restype = ctypes.c_longlong
    return lib


def serving_init(
    n_streams: int,
    *,
    kcfg: KalmanConfig | NlmsConfig | None = None,
    scfg: StftConfig = StftConfig(),
    e_bands: int = 32,
    stage1: str = "kalman",
    device="cuda",
) -> ServingState:
    """Zero state for ``n_streams`` sessions on ``device`` (the card unless
    the caller asks for ``device="cpu"``). ``stage1``
    picks the filter, ``kcfg`` its config (None: its defaults). Kalman:
    P = init_p, psi = psi_floor; NLMS: ``p`` is the (S, K) far power. Every
    other leaf starts at 0."""
    _check_serving_stage1(stage1)
    kcfg = _filter_cfg(kcfg, stage1)
    s, l, k, hop = n_streams, kcfg.n_blocks, scfg.n_freqs, scfg.hop
    init = _init_values(kcfg, stage1)
    full = functools.partial(torch.full, dtype=torch.float32, device=device)
    z = functools.partial(full, fill_value=0.0)
    return {
        "wr": z((s, l, k)), "wi": z((s, l, k)),
        "p": full((s, l, k) if stage1 == "kalman" else (s, k), init.get("p", 0.0)),
        "xbr": z((s, l, k)), "xbi": z((s, l, k)),
        "psi": full((s, k), init.get("psi", 0.0)),
        "fprev": z((s, hop)), "h": z((s, e_bands)), "tail": z((s, hop)),
        "prev_lin": z((s, hop)), "prev_far": z((s, hop)), "nm": z((s, _NM_ROWS)),
    }


def serving_state_from_stream(state, *, stage1: str = "kalman") -> ServingState:
    """A batched ``StreamState`` (leading stream axis) -> a new
    ``ServingState``, for migrating live sessions onto the kernel. ``stage1``
    names the filter the state was built for (NLMS's ``power`` becomes
    ``p``). The monitor rows of ``nm``, which ``StreamState`` does not
    carry, start at 0."""
    _check_serving_stage1(stage1)
    s1 = state["stage1"]
    k = s1["w"].shape[-1] // 2
    n = state["norm"]
    moments = [n["count"], n["sum_lin"], n["sumsq_lin"], n["sum_far"], n["sumsq_far"]]
    zero = torch.zeros_like(n["count"])
    return {
        "wr": s1["w"][..., :k].contiguous(), "wi": s1["w"][..., k:].contiguous(),
        "p": (s1["p"] if stage1 == "kalman" else s1["power"]).clone(),
        "xbr": s1["x_buf"][..., :k].contiguous(), "xbi": s1["x_buf"][..., k:].contiguous(),
        "psi": s1["psi"].clone(),
        "fprev": state["prev_far"].clone(), "h": state["gru_h"][:, 0].contiguous(),
        "tail": state["syn_tail"].clone(), "prev_lin": state["prev_lin"].clone(),
        "prev_far": state["prev_far"].clone(),
        "nm": torch.stack(moments + [zero] * 3, dim=1),
    }


def serving_state_to_stream(kstate: ServingState, *, stage1: str = "kalman") -> dict:
    """``ServingState`` -> a new batched ``StreamState``: the inverse of
    :func:`serving_state_from_stream`, exact. Use it to flush a session
    (``stream_flush``) or to resume it on the plain streaming path."""
    _check_serving_stage1(stage1)
    nm = kstate["nm"]
    return {
        "stage1": {
            "w": torch.cat([kstate["wr"], kstate["wi"]], -1),
            "p" if stage1 == "kalman" else "power": kstate["p"].clone(),
            "x_buf": torch.cat([kstate["xbr"], kstate["xbi"]], -1),
            "psi": kstate["psi"].clone(),
        },
        "prev_lin": kstate["prev_lin"].clone(),
        "prev_far": kstate["prev_far"].clone(),
        "gru_h": kstate["h"][:, None, :].clone(),
        "syn_tail": kstate["tail"].clone(),
        "norm": {name: nm[:, i].clone() for i, name in enumerate(
            ("count", "sum_lin", "sumsq_lin", "sum_far", "sumsq_far"))},
    }


def serving_reset_streams(
    state: ServingState,
    done: torch.Tensor,  # (S,) bool: True resets this stream's slot
    *,
    kcfg: KalmanConfig | NlmsConfig | None = None,
    stage1: str = "kalman",
) -> ServingState:
    """Session eviction and admission: re-initialize the marked stream
    slots IN PLACE to their :func:`serving_init` values (Kalman: init_p /
    psi_floor for P / psi; zeros elsewhere and for NLMS), so a finished
    call's slot takes a new one without re-allocating. Returns ``state``."""
    _check_serving_stage1(stage1)
    done = torch.as_tensor(done, dtype=torch.bool, device=state["wr"].device)
    init = _init_values(_filter_cfg(kcfg, stage1), stage1)
    for key in _KEYS:
        state[key][done] = init.get(key, 0.0)
    return state


def serving_erle(state: ServingState) -> torch.Tensor:
    """Per-stream stage-1 ERLE estimate (dB), (S,), from the health-monitor
    EMAs of ``nm`` rows 5-6 (mic / stage-1-residual block power, 0.99 EMA
    per 16 ms block ~ 1.6 s time constant). A cheap live health signal,
    reading low in double-talk; fresh slots read 0 dB until it warms up."""
    nm = state["nm"]
    eps = 1e-12
    return 10.0 * torch.log10((nm[:, 5] + eps) / (nm[:, 6] + eps))


def _blocks(far: torch.Tensor, mic: torch.Tensor, state: ServingState, hop: int) -> int:
    s = state["wr"].shape[0]
    kb, rem = divmod(far.shape[-1], hop)
    if far.shape != mic.shape or far.ndim != 2 or far.shape[0] != s or rem or kb < 1:
        raise ValueError(
            f"far/mic must both be (S={s}, k * {hop}) with k >= 1, got "
            f"{tuple(far.shape)}, {tuple(mic.shape)}"
        )
    return kb


@torch.no_grad()
def serving_step_plain(
    net: LittleNet,
    state: ServingState,
    far: torch.Tensor,  # (S, k * hop)
    mic: torch.Tensor,
    erb: torch.Tensor,
    kcfg: KalmanConfig | NlmsConfig | None = None,
    scfg: StftConfig = StftConfig(),
    *,
    normalize: bool = False,
    gain_norm: bool = False,
    stage1: str = "kalman",
) -> tuple[ServingState, torch.Tensor]:
    """Plain version of K3: k hops of ``pipeline/streaming``'s step plus the
    monitor rows of ``nm``, on any device. The state is updated in place, as
    the kernel updates it; returns ``(state, out (S, k * hop))``."""
    _check_serving_stage1(stage1)
    hop = scfg.hop
    kb = _blocks(far, mic, state, hop)
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    st = serving_state_to_stream(state, stage1=stage1)
    nm = state["nm"]
    mon = nm[:, 5].clone(), nm[:, 6].clone()
    outs = []
    for u in range(kb):
        far_b, mic_b = far[:, u * hop : (u + 1) * hop], mic[:, u * hop : (u + 1) * hop]
        st, out = _stream_step_core(
            net, st, far_b, mic_b, erb, scfg, stage1, kcfg, normalize, gain_norm
        )
        res = st["prev_lin"]  # this hop's stage-1 output block
        mon = (
            MONITOR_SMOOTH * mon[0] + (1.0 - MONITOR_SMOOTH) * torch.mean(mic_b * mic_b, -1),
            MONITOR_SMOOTH * mon[1] + (1.0 - MONITOR_SMOOTH) * torch.mean(res * res, -1),
        )
        outs.append(out)
    new = serving_state_from_stream(st, stage1=stage1)
    new["nm"][:, 5], new["nm"][:, 6], new["nm"][:, 7] = mon[0], mon[1], nm[:, 7]
    for key in _KEYS:
        state[key].copy_(new[key])
    return state, torch.cat(outs, -1)


def _check(net: LittleNet, state: ServingState, far: torch.Tensor, mic: torch.Tensor,
           erb: torch.Tensor, kcfg, scfg: StftConfig, stage1: str) -> None:
    dev = far.device
    tensors = {"far": far, "mic": mic, **state}
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"far, mic and every state leaf must be on one CUDA device, got {dev}")
    for key, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{key} must be a contiguous float32 tensor")
    if kcfg.n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {kcfg.n_blocks}")
    check_net(net, erb, scfg, dev)
    s, l, k, hop, e = far.shape[0], kcfg.n_blocks, scfg.n_freqs, scfg.hop, net.hidden
    want = {key: (s, l, k) for key in ("wr", "wi", "p", "xbr", "xbi")}
    if stage1 == "nlms":
        want["p"] = (s, k)
    want.update(psi=(s, k), fprev=(s, hop), h=(s, e), tail=(s, hop), prev_lin=(s, hop),
                prev_far=(s, hop), nm=(s, _NM_ROWS))
    for key, shape in want.items():
        if tuple(state[key].shape) != shape:
            raise ValueError(f"state[{key!r}] must be {shape}, got {tuple(state[key].shape)}")


def serving_step_fused(
    net: LittleNet,
    state: ServingState,
    far: torch.Tensor,  # (S, k * hop): k >= 1 queued 16 ms blocks per stream
    mic: torch.Tensor,
    erb: torch.Tensor,
    kcfg: KalmanConfig | NlmsConfig | None = None,
    scfg: StftConfig = StftConfig(),
    *,
    normalize: bool = False,
    gain_norm: bool = False,
    stage1: str = "kalman",
) -> tuple[ServingState, torch.Tensor]:
    """k >= 1 hops of 16 ms for S streams -> ``(state, out (S, k * hop))``,
    the state tensors updated in place (the counterpart of JAX's donation
    and ``input_output_aliases``).

    ``k`` is ``far.shape[1] // hop``: k = 1 is the realtime hot loop, k > 1
    the chunked dispatch, equal to k single-block calls but paying the state
    round trip once. The output lags the input by one hop; the first emitted
    block is the offline path's trimmed left edge (discard it). End of
    stream: ``serving_state_to_stream`` then ``stream_flush`` (a zero-block
    kernel step would fold the pad into the running moments).

    ``normalize`` is the causal running pseudo-norm of ``pipeline/streaming``;
    ``gain_norm`` the scale-sane ERB synthesis. ``stage1`` ("kalman" or
    "nlms") must name the filter the state was built for, ``kcfg`` its
    config. A CUDA tensor launches K3 (or raises); a CPU tensor takes
    :func:`serving_step_plain`.
    """
    if far.device.type == "cpu":
        return serving_step_plain(net, state, far, mic, erb, kcfg, scfg, normalize=normalize,
                                  gain_norm=gain_norm, stage1=stage1)
    _check_serving_stage1(stage1)
    kcfg = _filter_cfg(kcfg, stage1)
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    lib = _lib()
    kb = _blocks(far, mic, state, scfg.hop)
    _check(net, state, far, mic, erb, kcfg, scfg, stage1)
    bands = erb.shape[-1]
    _build.check_smem(
        lib.aec_serving_smem(scfg.hop, kcfg.n_blocks, bands, int(stage1 == "nlms")), far.device,
        "the serving kernel")
    out = torch.empty_like(far)
    keep = stage2_operands(net, erb, scfg)
    entry, operands = (lib.aec_serving, kalman_operands) if stage1 == "kalman" else (
        lib.aec_serving_nlms, nlms_operands)
    s1 = operands(kcfg, far.device, scfg.hop)
    err = entry(
        _build.ptr(far), _build.ptr(mic), _build.ptr(out), *(_build.ptr(state[k]) for k in _KEYS),
        far.shape[0], kb, *s1[:2], bands, *s1[2:], *map(_build.ptr, keep),
        int(gain_norm), int(normalize), far.device.index, _build.stream_of(far),
    )
    _build.check(err, "serving")
    serving_step_fused.launches += 1
    return state, out


serving_step_fused.launches = 0
