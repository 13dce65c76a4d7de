"""The two-stage hop K3 and K4 share (``csrc/hop.cuh``): its host side and a plain-torch model.

Host side. :func:`prepare` builds, once per net, ERB matrix, filter config,
STFT geometry and device, what a K3 or K4 launch takes that does not change
from call to call, and caches it: the stage-2 weights transposed to (in,
out), the ERB matrix's support ranges, the twiddles and radix plan (or the
dense bases for a hop without a plan), the filter constants, the shared-
memory check, all packed into one :class:`HopConsts` the launch passes by
address. The cache is keyed on each parameter's and ``erb``'s
``data_ptr()`` and ``_version``, so an optimizer step, ``load_state_dict``
or a ``copy_`` into a weight makes the next call prepare again (an in-place
change through ``.data`` bypasses the version counter: call
:func:`clear_cache` after one). An entry holds the parameters it was made
from, so no other tensor can take their addresses while it lives.
``prepare.builds`` counts the launches built because the cache had no entry.

Model. :func:`hop_model` is a plain-torch model of the hop on FFTs, which
``serving.serving_step_modeled`` and ``two_stage.two_stage_fused_modeled``
drive as K3 and K4 do, for the CPU tests (as
``kernels/stage2.py::little_net_apply_phased`` models K2): the stage-1 step
on :func:`fft_plan.rfft` / :func:`fft_plan.irfft` (the kernel's Stockham
schedule) with the far-spectrum ring in the kernel's slots and a Kalman
state held as the next block's prediction between hops, the hand-off with
the monitor rows and running moments, and the frame on the same FFTs: the
windowed transforms with the pseudo-norm offsets subtracted in the loads,
window x irfft as the synthesis.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.stft import StftConfig, magnitude, split_complex
from aec_tpu_torch.kernels import _build, fft_plan
from aec_tpu_torch.kernels.consts import stage1_consts, stage2_consts
from aec_tpu_torch.kernels.kalman import filter_constants
from aec_tpu_torch.kernels.nlms import nlms_constants
from aec_tpu_torch.kernels.stage2 import check_net, erb_support
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.ops.gru import gru_cell
from aec_tpu_torch.pipeline.streaming import _norm_scalar as norm_scalar

# Stage2Weights of csrc/bl_common.cuh, in order
STAGE2_FIELDS = ("analysis", "synthesis", "erb", "erb_t", "w_ih_t", "w_hh_t", "b_ih", "b_hh",
                 "w1_t", "b1", "w2_t", "b2", "inv_env", "window", "sup")
CACHE_SIZE = 8  # prepared launches kept, newest last

# per-block EMA coefficient of the serving health monitor (16 ms blocks ->
# ~1.6 s time constant), as the JAX package
MONITOR_SMOOTH = 0.99


class HopConsts(ctypes.Structure):
    """Mirror of ``HopConsts`` in ``csrc/hop.cuh``."""

    _fields_ = [
        ("block", ctypes.c_int), ("n_blocks", ctypes.c_int), ("bands", ctypes.c_int),
        ("n_pass", ctypes.c_int), ("radix", ctypes.c_int * fft_plan.MAX_PASSES),
        ("c", ctypes.c_float * 8), ("tw", ctypes.c_void_p), ("fwd", ctypes.c_void_p),
        ("inv_tail", ctypes.c_void_p), ("inv_head", ctypes.c_void_p),
        *[(name, ctypes.c_void_p) for name in STAGE2_FIELDS],
    ]


@dataclasses.dataclass
class Prepared:
    consts: HopConsts
    ref: ctypes.c_void_p  # the address of consts, as the C entries take it
    step: str  # "fft" or "dense"
    keep: list  # what consts points into, and the parameters the entry was made from


_CACHE: OrderedDict = OrderedDict()


def clear_cache() -> None:
    """Forget every prepared launch."""
    _CACHE.clear()


def check_consts(lib: ctypes.CDLL) -> None:
    """Raise unless the library's ``HopConsts`` is the size of the mirror."""
    lib.aec_hop_consts_bytes.restype = ctypes.c_longlong
    size = lib.aec_hop_consts_bytes()
    if size != ctypes.sizeof(HopConsts):
        raise RuntimeError(f"HopConsts is {size} B in the kernel library and "
                           f"{ctypes.sizeof(HopConsts)} B in kernels/hop.py")


def _stage2_tensors(net: LittleNet, erb: torch.Tensor, scfg: StftConfig) -> dict:
    c = stage2_consts(scfg, erb.device)
    gp = {k: v.detach() for k, v in net.gru_params().items()}
    return {
        "analysis": c["analysis"], "synthesis": c["synthesis"], "erb": erb.contiguous(),
        "erb_t": erb.T.contiguous(), "w_ih_t": gp["w_ih"].T.contiguous(),
        "w_hh_t": gp["w_hh"].T.contiguous(), "b_ih": gp["b_ih"].contiguous(),
        "b_hh": gp["b_hh"].contiguous(), "w1_t": net.linear1.weight.detach().T.contiguous(),
        "b1": net.linear1.bias.detach().contiguous(),
        "w2_t": net.linear2.weight.detach().T.contiguous(),
        "b2": net.linear2.bias.detach().contiguous(), "inv_env": c["inv_env"],
        "window": c["window"], "sup": erb_support(erb),
    }


def _weights(net: LittleNet) -> list[torch.Tensor]:
    """The parameters the stage-2 device code reads: the GRU's, lin1's and
    lin2's (a LittleNet has no others)."""
    l1, l2 = net.linear1, net.linear2
    return [*net.gru_params().values(), l1.weight, l1.bias, l2.weight, l2.bias]


def prepare(net: LittleNet, erb: torch.Tensor, kcfg, scfg: StftConfig,
            device: torch.device, smem, what: str) -> Prepared:
    """The prepared launch of K3 or K4 for this net, ``erb`` (fp32 on
    ``device``), filter config and geometry, from the cache or built now.
    ``smem(fft)`` is the kernel's shared memory per CTA for the FFT (True) or
    the dense hop; building raises when one CTA cannot hold it, or when the
    net and erb are not what the stage-2 device code takes. (An in-place
    change bumps ``_version``; a tensor's dtype and shape cannot change
    while it keeps its storage, which the entry holds.)"""
    params = _weights(net)
    key = (type(kcfg), kcfg, scfg, device, erb.data_ptr(), erb._version, erb.shape,
           *((p.data_ptr(), p._version) for p in params))
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        return hit
    check_net(net, erb, scfg, device)
    if kcfg.n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {kcfg.n_blocks}")
    hop, plan = scfg.hop, fft_plan.radix_plan(scfg.hop)
    _build.check_smem(smem(plan is not None), device, what)
    s2 = _stage2_tensors(net, erb, scfg)
    s1 = stage1_consts(hop, device)
    tw = fft_plan.twiddles(hop, device)
    consts = HopConsts(
        block=hop, n_blocks=kcfg.n_blocks, bands=erb.shape[-1],
        n_pass=0 if plan is None else len(plan),
        radix=(ctypes.c_int * fft_plan.MAX_PASSES)(*(plan or ())),
        c=(ctypes.c_float * 8)(*(nlms_constants(kcfg) if isinstance(kcfg, NlmsConfig)
                                 else filter_constants(kcfg))),
        tw=tw.data_ptr(), fwd=s1["fwd"].data_ptr(), inv_tail=s1["inv_tail"].data_ptr(),
        inv_head=s1["inv_head"].data_ptr(),
        **{name: s2[name].data_ptr() for name in STAGE2_FIELDS},
    )
    out = Prepared(consts, ctypes.cast(ctypes.pointer(consts), ctypes.c_void_p),
                   "dense" if plan is None else "fft",
                   [tw, *s1.values(), *s2.values(), erb, *params])
    _CACHE[key] = out
    while len(_CACHE) > CACHE_SIZE:
        _CACHE.popitem(last=False)
    prepare.builds += 1
    return out


prepare.builds = 0


# ---------------------------------------------------------------- plain-torch model


def _rfft(x: torch.Tensor, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    return split_complex(fft_plan.rfft(x, hop))


def stage1_model(kcfg, s: dict, t: int, hop: int, last: bool) -> None:
    """One stage-1 step of ``csrc/stage1_fft.cuh`` on the state ``s`` (in
    place): ``frame`` (S, 2B) [previous || current far block], ``e`` (S, B)
    mic in, cancelled block out, the ring ``xr``, ``xi`` (S, L, K) in slots
    (partition l at slot (t - l) mod L), ``wr``, ``wi`` (S, L, K) and, for
    Kalman, ``p`` held as block t's prediction (block t + 1's after the
    step, the posterior if ``last``)."""
    kalman = isinstance(kcfg, KalmanConfig)
    L = s["wr"].shape[1]
    head = t % L
    s["xr"][:, head], s["xi"][:, head] = _rfft(s["frame"], hop)
    s["frame"] = torch.cat([s["frame"][:, hop:], s["frame"][:, hop:]], -1)
    slots = [(head - l) % L for l in range(L)]
    xr, xi = s["xr"][:, slots], s["xi"][:, slots]  # (S, L, K) by partition
    wr, wi = s["wr"], s["wi"]
    x2 = xr * xr + xi * xi
    if not kalman:
        s["power"] = kcfg.power_smooth * s["power"] + (1.0 - kcfg.power_smooth) * x2.sum(1)
    y = torch.cat([(wr * xr - wi * xi).sum(1), (wr * xi + wi * xr).sum(1)], -1)
    s["e"] = s["e"] - fft_plan.irfft(y, hop, "tail")
    er, ei = _rfft(torch.cat([torch.zeros_like(s["e"]), s["e"]], -1), hop)
    if kalman:
        psi = kcfg.obs_smooth * s["psi"] + (1.0 - kcfg.obs_smooth) * (er * er + ei * ei)
        s["psi"] = psi = torch.clamp_min(psi, kcfg.psi_floor)
        den = (x2 * s["p"]).sum(1) + 2.0 * psi
        erd, eid = (er / den)[:, None], (ei / den)[:, None]
        g = torch.cat([s["p"] * (xr * erd + xi * eid), s["p"] * (xr * eid - xi * erd)], -1)
        s["p"] = torch.clamp_min(s["p"] * (1.0 - s["p"] * x2 / den[:, None]), kcfg.psi_floor)
    else:
        s["psi"] = kcfg.err_smooth * s["psi"] + (1.0 - kcfg.err_smooth) * (er * er + ei * ei)
        inv = 1.0 / (s["power"] + kcfg.eps + kcfg.eps_rel * s["power"].mean(-1, keepdim=True)
                     + kcfg.beta * s["psi"])
        er_, ei_, inv = er[:, None], ei[:, None], inv[:, None]
        g = torch.cat([(xr * er_ + xi * ei_) * inv, (xr * ei_ - xi * er_) * inv], -1)
    head_t = fft_plan.irfft(g, hop, "head")  # (S, L, B)
    ur, ui = _rfft(torch.cat([head_t, torch.zeros_like(head_t)], -1), hop)
    if kalman:
        wr, wi = wr + ur, wi + ui
        if last:
            s["wr"], s["wi"] = wr, wi
        else:
            predict_model(kcfg, s, wr, wi)
    else:
        s["wr"], s["wi"] = wr + kcfg.mu * ur, wi + kcfg.mu * ui


def predict_model(kcfg: KalmanConfig, s: dict, wr: torch.Tensor, wi: torch.Tensor) -> None:
    """The Kalman prediction from W = (wr, wi) and ``s["p"]`` into ``s``."""
    a2 = kcfg.a * kcfg.a
    s["p"] = a2 * s["p"] + (1.0 - a2) * (wr * wr + wi * wi) + kcfg.q_min
    s["wr"], s["wi"] = kcfg.a * wr, kcfg.a * wi


def frame_model(net: LittleNet, s: dict, erb: torch.Tensor, scfg: StftConfig, gain_norm: bool,
                off_lin, off_far) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame of ``csrc/stage2_fft.cuh``: ``s`` holds ``lin``, ``far``
    (S, 2B) [previous || current block], ``h`` (S, E) and ``tail`` (S, B),
    updated in place; -> (out (S, B), mask (S, E))."""
    hop, c = scfg.hop, stage2_consts(scfg, erb.device)
    win = c["window"]
    spec = fft_plan.rfft((s["lin"] - off_lin) * win, hop)
    fspec = fft_plan.rfft((s["far"] - off_far) * win, hop)
    for key in ("lin", "far"):
        s[key] = torch.cat([s[key][:, hop:], s[key][:, hop:]], -1)
    me, fe = magnitude(spec) @ erb, magnitude(fspec) @ erb
    gp = net.gru_params()
    s["h"] = gru_cell(gp, s["h"], torch.cat([me, torch.abs(me - fe)], -1) @ gp["w_ih"].T
                      + gp["b_ih"])
    mask = torch.sigmoid(net.linear2(torch.relu(net.linear1(torch.cat([s["h"], me], -1)))))
    gain = (mask * me) @ erb.T
    if gain_norm:
        gain = gain / (me @ erb.T + 1e-9)
    re, im = split_complex(spec)
    y = torch.cat([gain * re, gain * im], -1)
    out = (s["tail"] + win[:hop] * fft_plan.irfft(y, hop, "head")) * c["inv_env"] + 1e-9
    s["tail"] = win[hop:] * fft_plan.irfft(y, hop, "tail")
    return out, mask


def hop_model(net: LittleNet, kcfg, s: dict, t: int, erb: torch.Tensor, scfg: StftConfig,
              gain_norm: bool, moments: bool, normalize: bool,
              last: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop of ``csrc/hop.cuh`` on ``s`` (:func:`stage1_model`'s and
    :func:`frame_model`'s leaves, and ``nm`` with ``moments``): before it
    ``s["frame"][:, B:]`` holds far block t and ``s["e"]`` mic block t ->
    (out block t - 1, mask). ``moments``, ``normalize`` and ``last`` as the
    kernel's."""
    hop = scfg.hop
    mic2 = (s["e"] * s["e"]).sum(-1)
    stage1_model(kcfg, s, t, hop, last)
    lin_b, far_b = s["e"], s["frame"][:, hop:]
    s["lin"] = torch.cat([s["lin"][:, :hop], lin_b], -1)
    s["far"] = torch.cat([s["far"][:, :hop], far_b], -1)
    off_lin = off_far = 0.0
    if moments:
        nm = s["nm"]
        nm[:, 5] = MONITOR_SMOOTH * nm[:, 5] + (1.0 - MONITOR_SMOOTH) * (mic2 / hop)
        nm[:, 6] = (MONITOR_SMOOTH * nm[:, 6]
                    + (1.0 - MONITOR_SMOOTH) * ((lin_b * lin_b).sum(-1) / hop))
        if normalize:
            nm[:, 0] += hop
            nm[:, 1] += lin_b.sum(-1)
            nm[:, 2] += (lin_b * lin_b).sum(-1)
            nm[:, 3] += far_b.sum(-1)
            nm[:, 4] += (far_b * far_b).sum(-1)
            off_lin = norm_scalar(nm[:, 1], nm[:, 2], nm[:, 0])[:, None]
            off_far = norm_scalar(nm[:, 3], nm[:, 4], nm[:, 0])[:, None]
    return frame_model(net, s, erb, scfg, gain_norm, off_lin, off_far)
