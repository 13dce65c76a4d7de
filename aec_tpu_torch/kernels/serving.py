"""Kernel K3: the two-stage serving step for S live streams, as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_serving.py:239`` (``serving_step_fused``,
``pallas_call`` at ``:320``). The serving hot loop advances S live calls by
k >= 1 hops of 16 ms per call: per stream and hop one stage-1 block update
(Kalman or NLMS, ``stage1``), its cancelled block handed to one LittleNet
frame, with the one-hop output lag of ``pipeline/streaming``. The kernel is
``csrc/serving.cu`` on the two-stage hop of ``csrc/hop.cuh``, one template
over the filter: one CTA per stream loads the stream's state (~56 KB with
Kalman, ~47 KB with NLMS) into shared memory, runs the k hops with both
stages' transforms as real FFTs in shared memory, and writes the state back
in place. A hop with a prime factor other than 2, 3 and 5 runs the dense
hop (DFT bases read from L2) instead; ``steps`` counts which ran. Each
call's constants (weights transposed, ERB support, plan, shared-memory
check) are prepared once and cached (:func:`kernels.hop.prepare`), so a
call checks its inputs and launches. The source's header has the reckoning.

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
tensors only; :func:`serving_step_modeled` is a plain-torch model of the
kernel's FFT route for the CPU tests. The JAX wrapper's TPU knobs
(``tile``, ``interpret``, ``dot_mode``, ``vmem_limit_mb``) have no meaning
here and are left out: every product is plain fp32, the JAX
``dot_mode="high"`` grade.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import _build, hop
from aec_tpu_torch.kernels.hop import MONITOR_SMOOTH
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.pipeline.streaming import _check_stage1, _stream_step_core

ServingState = dict[str, torch.Tensor]

_KEYS = ("wr", "wi", "p", "xbr", "xbi", "psi", "fprev", "h", "tail", "prev_lin",
         "prev_far", "nm")
_NM_ROWS = 8


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
    # the prepared constants, the filter, far, mic, out, the 12 state
    # pointers, streams and blocks, the flags, the device and the stream
    lib.aec_serving.argtypes = [p, i, p, p, p, ctypes.POINTER(p), i, i, i, i, i, p]
    lib.aec_serving.restype = ctypes.c_int
    lib.aec_serving_smem.argtypes = [i, i, i, i, i]
    lib.aec_serving_smem.restype = ctypes.c_longlong
    hop.check_consts(lib)
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


@torch.no_grad()
def serving_step_modeled(
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
    """A plain-torch model of K3's FFT route for the CPU tests, with
    :func:`serving_step_plain`'s signature; the state is updated in place.
    As the kernel: the load (age a into ring slot L - 1 - a, a Kalman W, P
    predicted once), k hops of :func:`kernels.hop.hop_model`, the last one
    leaving the posterior, and the store (slot (k - 1 - l) mod L back to age
    l)."""
    _check_serving_stage1(stage1)
    kb = _blocks(far, mic, state, scfg.hop)
    erb = torch.as_tensor(erb, dtype=torch.float32, device=far.device)
    kcfg, h = _filter_cfg(kcfg, stage1), scfg.hop
    L = kcfg.n_blocks
    load = [L - 1 - a for a in range(L)]  # the slot of age a
    s = {"wr": state["wr"].clone(), "wi": state["wi"].clone(), "psi": state["psi"].clone(),
         "xr": torch.empty_like(state["xbr"]), "xi": torch.empty_like(state["xbi"]),
         "frame": torch.cat([state["fprev"]] * 2, -1),
         "lin": torch.cat([state["prev_lin"]] * 2, -1),
         "far": torch.cat([state["prev_far"]] * 2, -1), "h": state["h"].clone(),
         "tail": state["tail"].clone(), "nm": state["nm"].clone()}
    s["xr"][:, load], s["xi"][:, load] = state["xbr"], state["xbi"]
    if stage1 == "kalman":
        s["p"] = state["p"].clone()
        hop.predict_model(kcfg, s, s["wr"], s["wi"])
    else:
        s["power"] = state["p"].clone()
    outs = []
    for u in range(kb):
        blk = slice(u * h, (u + 1) * h)
        s["frame"] = torch.cat([s["frame"][:, :h], far[:, blk]], -1)
        s["e"] = mic[:, blk]
        outs.append(hop.hop_model(net, kcfg, s, u, erb, scfg, gain_norm, True, normalize,
                                  u == kb - 1)[0])
    store = [(kb - 1 - l) % L for l in range(L)]
    new = {"wr": s["wr"], "wi": s["wi"], "p": s["p"] if stage1 == "kalman" else s["power"],
           "xbr": s["xr"][:, store], "xbi": s["xi"][:, store], "psi": s["psi"],
           "fprev": s["frame"][:, :h], "h": s["h"], "tail": s["tail"],
           "prev_lin": s["lin"][:, :h], "prev_far": s["far"][:, :h], "nm": s["nm"]}
    for key in _KEYS:
        state[key].copy_(new[key])
    return state, torch.cat(outs, -1)


def _check(state: ServingState, far: torch.Tensor, mic: torch.Tensor, kcfg, scfg: StftConfig,
           bands: int, stage1: str) -> tuple[int, list[int]]:
    """Raise unless far, mic and the state are what the kernel takes; ->
    (the blocks per stream, the state leaves' addresses in ``_KEYS`` order)."""
    kb = _blocks(far, mic, state, scfg.hop)
    dev, f32 = far.device, torch.float32
    s, l, k, h = far.shape[0], kcfg.n_blocks, scfg.n_freqs, scfg.hop
    lk, sk, sh = (s, l, k), (s, k), (s, h)
    want = (lk, lk, lk if stage1 == "kalman" else sk, lk, lk, sk, sh, (s, bands), sh, sh, sh,
            (s, _NM_ROWS))
    ptrs = []
    for key, shape in zip(_KEYS, want):
        t = state[key]
        if t.device != dev or t.dtype != f32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"state[{key!r}] must be a contiguous float32 {shape} tensor on the "
                             f"inputs' CUDA device {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        ptrs.append(t.data_ptr())
    for key, t in (("far", far), ("mic", mic)):
        if t.dtype != f32 or not t.is_contiguous():
            raise ValueError(f"{key} must be a contiguous float32 tensor")
    if mic.device != dev:
        raise ValueError(f"far and mic must be on one CUDA device, got {dev}, {mic.device}")
    return kb, ptrs


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
    :func:`serving_step_plain`. ``steps`` counts the launches on FFTs and on
    the dense hop. The net's weights and ``erb`` are prepared once
    (:func:`kernels.hop.prepare`: pass ``erb`` as a float32 tensor on the
    card, or it is copied there and prepared again on every call).
    """
    if far.device.type == "cpu":
        return serving_step_plain(net, state, far, mic, erb, kcfg, scfg, normalize=normalize,
                                  gain_norm=gain_norm, stage1=stage1)
    _check_serving_stage1(stage1)
    kcfg = _filter_cfg(kcfg, stage1)
    dev = far.device
    erb = torch.as_tensor(erb, dtype=torch.float32, device=dev)
    lib, nlms = _lib(), int(stage1 == "nlms")
    prep = hop.prepare(
        net, erb, kcfg, scfg, dev,
        lambda fft: lib.aec_serving_smem(scfg.hop, kcfg.n_blocks, erb.shape[-1], nlms, int(fft)),
        "the serving kernel")
    kb, ptrs = _check(state, far, mic, kcfg, scfg, erb.shape[-1], stage1)
    out = torch.empty_like(far)
    err = lib.aec_serving(
        prep.ref, nlms, far.data_ptr(), mic.data_ptr(), out.data_ptr(),
        (ctypes.c_void_p * len(_KEYS))(*ptrs),
        far.shape[0], kb, int(gain_norm), int(normalize), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "serving")
    serving_step_fused.steps[prep.step] += 1
    serving_step_fused.launches += 1
    return state, out


serving_step_fused.launches = 0
serving_step_fused.steps = {"fft": 0, "dense": 0}
