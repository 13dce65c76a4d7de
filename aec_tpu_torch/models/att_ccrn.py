"""ATT-CCRN, the attention-gated dual-encoder CRN post-filter (``aec_tpu/models/att_ccrn.py``).

The architecture the reference's module declarations describe
(attention_ccrn.py:240-374; its forward cannot run):

- two magnitude encoders, mic (PReLU) and far end (ReLU): real conv stacks
  (kernel (5, 1), stride (2, 1) over frequency, each conv + BatchNorm);
- an additive attention gate per level (``Attention_block``: 1x1 convs +
  BN, psi = sigmoid(conv(relu(g + x))), output x * psi) gating the far-end
  features by the mic features;
- an LSTM bottleneck over the concatenated deepest features (I = H = 4096
  at the default config);
- a decoder with gated skip concats emitting a 2-channel complex mask
  (tanh), the DC bin re-padded, applied to the mic spectrum, then iSTFT.

Layouts as in the JAX package, so its trees carry over leaf for leaf:
activations [B, F, T, C], conv kernels HWIO. The convolutions run as
``torch.nn.functional.conv2d`` / ``conv_transpose2d`` on channels-first
views (JAX computes them outside any Pallas kernel); on the card cuDNN
computes them in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False.

The bottleneck is one ``ops.lstm.lstm_scan`` with ``lstm_recurrent_dtype``
forwarded: ``"int8"`` on a CUDA tensor runs kernel K10. ``lstm_mesh`` (the
tensor-parallel bottleneck) is ROADMAP A6 and raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.models.tree_net import TreeNet
from aec_tpu_torch.ops import complex_layers as cl
from aec_tpu_torch.ops.lstm import lstm_init, lstm_scan


@dataclasses.dataclass(frozen=True)
class AttCcrnConfig:
    channels: tuple[int, ...] = (1, 16, 32, 64, 128)
    kernel: tuple[int, int] = (5, 1)
    stride: tuple[int, int] = (2, 1)
    padding: tuple[int, int] = (2, 0)
    stft: StftConfig = StftConfig()


def bottleneck_features(cfg: AttCcrnConfig) -> int:
    """2 x channels x frequency at the deepest level: the LSTM's width."""
    n = len(cfg.channels) - 1
    return 2 * cfg.channels[-1] * ((cfg.stft.n_freqs - 1) // (cfg.stride[0] ** n))


def _conv_init(c_in, c_out, kernel, generator, device) -> dict[str, torch.Tensor]:
    """N(0, 0.05) HWIO weights, zero bias; drawn on the CPU, then moved."""
    w = 0.05 * torch.randn((*kernel, c_in, c_out), generator=generator)
    return {"w": w.to(device), "b": torch.zeros(c_out, device=device)}


def _conv(p, x: torch.Tensor, stride, padding) -> torch.Tensor:
    """NHWC x, HWIO kernel, padding as (low, high) pairs per spatial dim."""
    (fl, fh), (tl, th) = cl._pairs(padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (tl, th, fl, fh))
    y = F.conv2d(xc, p["w"].permute(3, 2, 0, 1), p["b"], stride=tuple(stride))
    return y.permute(0, 2, 3, 1)


def _tconv(p, x: torch.Tensor, stride, padding, output_padding) -> torch.Tensor:
    """JAX's lhs-dilated conv of the flipped kernel with pads (k - 1 - p,
    k - 1 - p + output_padding) is ``conv_transpose2d`` of the unflipped
    kernel laid out (Cin, Cout, kh, kw)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].permute(2, 3, 0, 1), p["b"],
                           stride=tuple(stride), padding=tuple(padding),
                           output_padding=tuple(output_padding))
    return y.permute(0, 2, 3, 1)


_ONE = [(0, 0), (0, 0)]


def _att_init(f_g, f_l, f_int, generator, device):
    bn = {k: cl.batch_norm_init(c, device=device)
          for k, c in (("bn_g", f_int), ("bn_x", f_int), ("bn_psi", 1))}
    params = {"w_g": _conv_init(f_g, f_int, (1, 1), generator, device),
              "w_x": _conv_init(f_l, f_int, (1, 1), generator, device),
              "psi": _conv_init(f_int, 1, (1, 1), generator, device)}
    params.update({k: v[0] for k, v in bn.items()})
    return params, {k: v[1] for k, v in bn.items()}


def _att_apply(p, s, g, x, *, train: bool):
    """Attention_block forward (attention_ccrn.py:268-273)."""
    g1, bn_g = cl.batch_norm(p["bn_g"], s["bn_g"], _conv(p["w_g"], g, (1, 1), _ONE), train=train)
    x1, bn_x = cl.batch_norm(p["bn_x"], s["bn_x"], _conv(p["w_x"], x, (1, 1), _ONE), train=train)
    psi = _conv(p["psi"], torch.relu(g1 + x1), (1, 1), _ONE)
    psi, bn_psi = cl.batch_norm(p["bn_psi"], s["bn_psi"], psi, train=train)
    return x * torch.sigmoid(psi), {"bn_g": bn_g, "bn_x": bn_x, "bn_psi": bn_psi}


def att_ccrn_init(cfg: AttCcrnConfig = AttCcrnConfig(), *,
                  generator: torch.Generator | None = None, device="cuda") -> tuple[dict, dict]:
    """(params, state) trees; ``state`` carries the BatchNorm running
    statistics. Drawn on the CPU from ``generator`` (JAX draws its own
    numbers from its key), then moved to ``device``."""
    chans = cfg.channels
    n = len(chans) - 1
    params: dict[str, Any] = {"mic_enc": [], "far_enc": [], "att": [], "decoder": []}
    state: dict[str, Any] = {"mic_enc": [], "far_enc": [], "att": [], "decoder": []}
    for i in range(n):
        for name in ("mic_enc", "far_enc"):
            conv = _conv_init(chans[i], chans[i + 1], cfg.kernel, generator, device)
            bn_p, bn_s = cl.batch_norm_init(chans[i + 1], device=device)
            params[name].append({"conv": conv, "bn": bn_p, "prelu": cl.prelu_init(device=device)})
            state[name].append({"bn": bn_s})
        att_p, att_s = _att_init(chans[i + 1], chans[i + 1], max(chans[i + 1] // 2, 1),
                                 generator, device)
        params["att"].append(att_p)
        state["att"].append(att_s)
        # decoder level i consumes [up(out) || mic_skip || far_gated_skip]
        c_dec_in = 2 * chans[n - i] if i == 0 else 3 * chans[n - i]
        c_out = chans[n - i - 1] if i < n - 1 else 2
        dconv = _conv_init(c_dec_in, c_out, cfg.kernel, generator, device)
        bn_p, bn_s = cl.batch_norm_init(c_out, device=device)
        params["decoder"].append({"conv": dconv, "bn": bn_p, "prelu": cl.prelu_init(device=device)})
        state["decoder"].append({"bn": bn_s})
    feat = bottleneck_features(cfg)
    params["lstm"] = lstm_init(feat, feat, generator=generator, device=device)
    return params, state


def att_ccrn_apply(params, state, mic: torch.Tensor, far: torch.Tensor,
                   cfg: AttCcrnConfig = AttCcrnConfig(), *, train: bool = False,
                   lstm_mesh=None, lstm_axis: str = "model", lstm_recurrent_dtype=None,
                   lstm_int8_kernel: bool | None = None) -> tuple[dict, dict]:
    """mic/far wav [B, n] -> (outputs, new_state). Outputs: ``wav`` [B, n],
    ``mask_re`` / ``mask_im`` [B, K, T], ``out_spec`` [B, T, 2K].

    ``lstm_recurrent_dtype`` goes to the bottleneck's ``lstm_scan``
    (``"int8"``: the quantized recurrence, inference only, K10 on a CUDA
    tensor); ``lstm_int8_kernel`` is its ``int8_kernel`` (False keeps a CUDA
    call on the plain int8 loop, K10's plain version). ``lstm_mesh`` is the
    tensor-parallel bottleneck, not ported (ROADMAP A6)."""
    del lstm_axis  # the mesh's axis name; the mesh route is not ported
    if lstm_mesh is not None:
        raise NotImplementedError(
            "lstm_mesh (the tensor-parallel bottleneck, parallel/tp_lstm) is not ported yet "
            "(ROADMAP A6)")
    scfg = cfg.stft
    mic_spec = stft_mod.stft(mic, scfg)  # [B, T, 2K]
    mic_mag = stft_mod.magnitude(mic_spec)
    far_mag = stft_mod.magnitude(stft_mod.stft(far, scfg))
    # grids [B, F, T, 1], DC dropped
    xm = mic_mag.transpose(-1, -2)[:, 1:, :, None]
    xf = far_mag.transpose(-1, -2)[:, 1:, :, None]

    pad = [(cfg.padding[0],) * 2, (cfg.padding[1],) * 2]
    new_state: dict[str, Any] = {"mic_enc": [], "far_enc": [], "att": [], "decoder": []}
    skips = []
    for i in range(len(params["mic_enc"])):
        lm, lf = params["mic_enc"][i], params["far_enc"][i]
        xm, bn_m = cl.batch_norm(lm["bn"], state["mic_enc"][i]["bn"],
                                 _conv(lm["conv"], xm, cfg.stride, pad), train=train)
        xm = cl.prelu(lm["prelu"], xm)
        xf, bn_f = cl.batch_norm(lf["bn"], state["far_enc"][i]["bn"],
                                 _conv(lf["conv"], xf, cfg.stride, pad), train=train)
        xf = torch.relu(xf)
        gated, att_s = _att_apply(params["att"][i], state["att"][i], xm, xf, train=train)
        new_state["mic_enc"].append({"bn": bn_m})
        new_state["far_enc"].append({"bn": bn_f})
        new_state["att"].append(att_s)
        skips.append(torch.cat([xm, gated], dim=-1))

    x = skips[-1]  # [B, F', T, 2C]
    b, f_b, t, c = x.shape
    lstm_in = x.permute(0, 2, 3, 1).reshape(b, t, c * f_b)
    seq, _ = lstm_scan(params["lstm"], lstm_in, recurrent_dtype=lstm_recurrent_dtype,
                       int8_kernel=lstm_int8_kernel)
    x = seq.reshape(b, t, c, f_b).permute(0, 3, 1, 2)

    for i, layer in enumerate(params["decoder"]):
        if i > 0:
            x = torch.cat([x, skips[-1 - i]], dim=-1)
        x, bn_s = cl.batch_norm(layer["bn"], state["decoder"][i]["bn"],
                                _tconv(layer["conv"], x, cfg.stride, cfg.padding, (1, 0)),
                                train=train)
        x = torch.tanh(x) if i == len(params["decoder"]) - 1 else cl.prelu(layer["prelu"], x)
        new_state["decoder"].append({"bn": bn_s})

    mask_re = F.pad(x[..., 0], (0, 0, 1, 0))  # [B, K, T]
    mask_im = F.pad(x[..., 1], (0, 0, 1, 0))
    re, im = split_complex(mic_spec)
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    est_re = re * mask_re - im * mask_im
    est_im = re * mask_im + im * mask_re
    out_spec = torch.cat([est_re.transpose(-1, -2), est_im.transpose(-1, -2)], dim=-1)
    return ({"wav": stft_mod.istft(out_spec, scfg), "mask_re": mask_re, "mask_im": mask_im,
             "out_spec": out_spec}, new_state)


def att_ccrn_loss(params, state, mic, far, near, cfg: AttCcrnConfig = AttCcrnConfig(), *,
                  train: bool = True) -> tuple[torch.Tensor, dict]:
    """Compressed-magnitude MSE of the masked spectrum against the near end."""
    out, new_state = att_ccrn_apply(params, state, mic, far, cfg, train=train)
    near_mag = stft_mod.magnitude(stft_mod.stft(near, cfg.stft))
    diff = torch.sqrt(stft_mod.magnitude(out["out_spec"])) - torch.sqrt(near_mag)
    return torch.mean(diff * diff), {"wav": out["wav"], "state": new_state}


class AttCcrn(TreeNet):
    """ATT-CCRN holding ``att_ccrn_init``'s (params, state) trees;
    ``forward(mic, far)`` is ``att_ccrn_apply`` in the module's mode."""

    apply_fn = att_ccrn_apply

    def __init__(self, params: dict, state: dict, cfg: AttCcrnConfig = AttCcrnConfig()):
        super().__init__(params, state, cfg)
