"""DCCRN, the deep complex convolution recurrent network for AEC (``aec_tpu/models/dccrn.py``).

- Inputs mic and far-end as a 2-complex-channel spectrogram grid, the DC bin
  dropped, layout [B, F, T, C] with channels [reals || imags].
- Encoder: 6 complex convs (channels 4 -> 16 -> ... -> 512 total, kernel
  (5, 1), stride (2, 1) over frequency), each with a BatchNorm (complex
  whitening with ``use_cbn``, else real) and a PReLU.
- Bottleneck: a plain LSTM over (channels x frequency) features (v1) or a
  stack of complex LSTMs (``use_clstm``, v2). At the default config these
  are two complex LSTMs at I = H = 1024 per real/imaginary part, which a
  CUDA tensor at batch <= 16 runs on kernel K9 (``ops/lstm``).
- Decoder: mirror transposed complex convs with complex skip-concats; the
  final 2-channel (complex) mask, the DC bin re-padded; the v2 head ends in
  a bare transposed conv.
- Masking modes 'E' (tanh magnitude + phase rotation), 'C' (complex
  multiply), 'R' (real multiply). Losses: v1 (0.3 cIRM-mask MSE + 0.7
  echo-leak MSE) and SI-SNR.

The functions keep the JAX package's names and signatures, on nested dicts
of tensors: ``dccrn_init`` -> (params, state), ``dccrn_apply(params, state,
mic, far, cfg, train=...)`` -> (outputs, new_state), the two losses. The
:class:`Dccrn` module holds the same two trees, the parameters as
``nn.Parameter`` s and the BatchNorm running statistics as buffers, and its
forward calls ``dccrn_apply`` on them (in train mode it writes the new
statistics back into the buffers).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.models.tree_net import TreeNet
from aec_tpu_torch.ops import complex_layers as cl
from aec_tpu_torch.ops.lstm import complex_lstm_init, complex_lstm_scan, lstm_init, lstm_scan
from aec_tpu_torch.train.metrics import si_snr


@dataclasses.dataclass(frozen=True)
class DccrnConfig:
    """Defaults mirror the reference's net_conf; ``v2_head`` True makes the
    default architecture v2 end to end (clstm + cbn + bare head + 'E')."""

    conv_channels: tuple[int, ...] = (4, 16, 32, 64, 128, 256, 512)
    kernel: tuple[int, int] = (5, 1)
    stride: tuple[int, int] = (2, 1)
    padding: tuple[int, int] = (2, 0)
    masking_mode: str = "E"  # 'E' | 'C' | 'R'
    use_clstm: bool = True
    use_cbn: bool = True
    rnn_layers: int = 2
    v2_head: bool = True
    stft: StftConfig = StftConfig()


def bottleneck_features(cfg: DccrnConfig) -> int:
    """Channels x frequency at the deepest level: the bottleneck's width."""
    f_bottom = (cfg.stft.n_freqs - 1) // (cfg.stride[0] ** (len(cfg.conv_channels) - 1))
    return cfg.conv_channels[-1] * f_bottom


def dccrn_init(cfg: DccrnConfig = DccrnConfig(), *, generator: torch.Generator | None = None,
               device="cuda") -> tuple[dict, dict]:
    """(params, state) trees; ``state`` carries the BatchNorm running
    statistics. Drawn on the CPU from ``generator`` (JAX draws its own
    numbers from its key), then moved to ``device``."""
    chans = cfg.conv_channels
    n_enc = len(chans) - 1
    kw = {"device": device}

    def bn_init(c):
        if cfg.use_cbn:
            return cl.complex_batch_norm_init(c, generator=generator, **kw)
        return cl.batch_norm_init(c, **kw)

    enc, enc_state = [], []
    for i in range(n_enc):
        conv = cl.complex_conv_init(chans[i], chans[i + 1], cfg.kernel, generator=generator, **kw)
        bn_p, bn_s = bn_init(chans[i + 1])
        enc.append({"conv": conv, "bn": bn_p, "prelu": cl.prelu_init(**kw)})
        enc_state.append({"bn": bn_s})

    dec, dec_state = [], []
    for i in range(n_enc - 1, -1, -1):
        c_out = chans[i] if i > 0 else 2
        layer = {"conv": cl.complex_conv_init(chans[i + 1] * 2, c_out, cfg.kernel,
                                              generator=generator, **kw)}
        bn_s = {}
        if i > 0 or not cfg.v2_head:
            layer["bn"], bn_s = bn_init(c_out)
        if i > 0:  # the final v1 stage ends in tanh, no PReLU
            layer["prelu"] = cl.prelu_init(**kw)
        dec.append(layer)
        dec_state.append({"bn": bn_s})

    feat = bottleneck_features(cfg)
    if cfg.use_clstm:
        rnn = [complex_lstm_init(feat, feat, generator=generator, **kw)
               for _ in range(cfg.rnn_layers)]
    else:
        rnn = lstm_init(feat, feat, generator=generator, **kw)
    return {"encoder": enc, "decoder": dec, "rnn": rnn}, {"encoder": enc_state,
                                                           "decoder": dec_state}


def _to_grid(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, 2K] -> real/imag grids [B, K, T] (frequency-major)."""
    re, im = split_complex(spec)
    return re.transpose(-1, -2), im.transpose(-1, -2)


def dccrn_apply(params, state, mic: torch.Tensor, far: torch.Tensor,
                cfg: DccrnConfig = DccrnConfig(), *, train: bool = False,
                lstm_fused: bool | None = None) -> tuple[dict, Any]:
    """mic/far wav [B, n] -> (outputs, new_state). Outputs: ``wav`` [B, n],
    ``mask_re`` / ``mask_im`` [B, K, T], ``mic_spec`` / ``out_spec``
    [B, T, 2K]. ``lstm_fused`` is the complex LSTMs' ``fused`` (None routes
    as ``ops.lstm.complex_lstm_scan`` does; False keeps a CUDA call on the
    plain loop, the kernel route's plain version)."""
    scfg = cfg.stft
    mic_spec = stft_mod.stft(mic, scfg)
    far_spec = stft_mod.stft(far, scfg)
    mic_re, mic_im = _to_grid(mic_spec)
    far_re, far_im = _to_grid(far_spec)

    # channel stack [mic_r, far_r || mic_i, far_i], DC dropped
    x = torch.stack([mic_re, far_re, mic_im, far_im], dim=-1)[:, 1:]  # [B, F, T, 4]
    bn_apply = cl.complex_batch_norm if cfg.use_cbn else cl.batch_norm

    new_enc_state, skips = [], []
    pad = [(cfg.padding[0],) * 2, (cfg.padding[1],) * 2]
    for layer, lstate in zip(params["encoder"], state["encoder"]):
        x = cl.complex_conv(layer["conv"], x, cfg.stride, pad)
        x, bn_s = bn_apply(layer["bn"], lstate["bn"], x, train=train)
        x = cl.prelu(layer["prelu"], x)
        new_enc_state.append({"bn": bn_s})
        skips.append(x)

    # bottleneck: [B, F', T, C] -> [B, T, C F'] (channel-major)
    b, f_b, t, c = x.shape
    if cfg.use_clstm:
        half = (c // 2) * f_b
        r_seq = x[..., : c // 2].permute(0, 2, 3, 1).reshape(b, t, half)
        i_seq = x[..., c // 2:].permute(0, 2, 3, 1).reshape(b, t, half)
        for lp in params["rnn"]:
            r_seq, i_seq = complex_lstm_scan(lp, r_seq, i_seq, fused=lstm_fused)
        r_g = r_seq.reshape(b, t, c // 2, f_b).permute(0, 3, 1, 2)
        i_g = i_seq.reshape(b, t, c // 2, f_b).permute(0, 3, 1, 2)
        x = torch.cat([r_g, i_g], dim=-1)
    else:
        seq, _ = lstm_scan(params["rnn"], x.permute(0, 2, 3, 1).reshape(b, t, c * f_b))
        x = seq.reshape(b, t, c, f_b).permute(0, 3, 1, 2)

    new_dec_state = []
    n_dec = len(params["decoder"])
    for i, (layer, lstate) in enumerate(zip(params["decoder"], state["decoder"])):
        x = cl.complex_cat([x, skips[-1 - i]])
        x = cl.complex_conv_transpose(layer["conv"], x, cfg.stride, cfg.padding,
                                      output_padding=(1, 0))
        last = i == n_dec - 1
        if last and cfg.v2_head:  # a bare conv
            bn_s = lstate["bn"]
        else:
            x, bn_s = bn_apply(layer["bn"], lstate["bn"], x, train=train)
            x = torch.tanh(x) if last else cl.prelu(layer["prelu"], x)
        new_dec_state.append({"bn": bn_s})

    # the mask, DC bin re-padded
    mask_re = nn.functional.pad(x[..., 0], (0, 0, 1, 0))  # [B, K, T]
    mask_im = nn.functional.pad(x[..., 1], (0, 0, 1, 0))

    if cfg.masking_mode == "E":
        mask_mag = torch.sqrt(mask_re ** 2 + mask_im ** 2)
        mask_phase = torch.atan2(mask_im / (mask_mag + 1e-8), mask_re / (mask_mag + 1e-8))
        mic_mag = torch.sqrt(mic_re ** 2 + mic_im ** 2 + 1e-8)
        mic_phase = torch.atan2(mic_im, mic_re)
        est_mag = torch.tanh(mask_mag) * mic_mag
        est_phase = mic_phase + mask_phase
        est_re, est_im = est_mag * torch.cos(est_phase), est_mag * torch.sin(est_phase)
    elif cfg.masking_mode == "C":
        est_re = mic_re * mask_re - mic_im * mask_im
        est_im = mic_re * mask_im + mic_im * mask_re
    elif cfg.masking_mode == "R":
        est_re, est_im = mic_re * mask_re, mic_im * mask_im
    else:
        raise ValueError(f"unknown masking mode {cfg.masking_mode!r}")

    out_spec = torch.cat([est_re.transpose(-1, -2), est_im.transpose(-1, -2)], dim=-1)
    outputs = {"wav": stft_mod.istft(out_spec, scfg), "mask_re": mask_re, "mask_im": mask_im,
               "mic_spec": mic_spec, "out_spec": out_spec}
    return outputs, {"encoder": new_enc_state, "decoder": new_dec_state}


def dccrn_loss_v1(params, state, mic, far, near, echo, cfg: DccrnConfig = DccrnConfig(), *,
                  train: bool = True) -> tuple[torch.Tensor, dict]:
    """v1 objective: 0.3 MSE(mask, cIRM) + 0.7 MSE(complex-masked echo, 0)."""
    out, new_state = dccrn_apply(params, state, mic, far, cfg, train=train)
    scfg = cfg.stft
    near_re, near_im = _to_grid(stft_mod.stft(near, scfg))
    echo_re, echo_im = _to_grid(stft_mod.stft(echo, scfg))
    mic_re, mic_im = _to_grid(out["mic_spec"])
    den = mic_re ** 2 + mic_im ** 2 + 1e-9
    cirm_r = (mic_re * near_re + mic_im * near_im) / den
    cirm_i = (mic_re * near_im - mic_im * near_re) / den
    loss_mask = (torch.mean((out["mask_re"] - cirm_r) ** 2)
                 + torch.mean((out["mask_im"] - cirm_i) ** 2))
    leak_r = echo_re * out["mask_re"] - echo_im * out["mask_im"]
    leak_i = echo_re * out["mask_im"] + echo_im * out["mask_re"]
    loss_echo = torch.mean(leak_r ** 2) + torch.mean(leak_i ** 2)
    return 0.3 * loss_mask + 0.7 * loss_echo, {"wav": out["wav"], "state": new_state}


def dccrn_loss_sisnr(params, state, mic, far, near, cfg: DccrnConfig = DccrnConfig(), *,
                     train: bool = True) -> tuple[torch.Tensor, dict]:
    """v2-style objective: the negative SI-SNR of the enhanced waveform."""
    out, new_state = dccrn_apply(params, state, mic, far, cfg, train=train)
    n = min(out["wav"].shape[-1], near.shape[-1])
    return -si_snr(out["wav"][..., :n], near[..., :n]), {"wav": out["wav"], "state": new_state}


# ---------------------------------------------------------------- the module

class Dccrn(TreeNet):
    """DCCRN holding ``dccrn_init``'s (params, state) trees: ``self.net``
    the parameters, ``self.stats`` the BatchNorm running statistics
    (buffers). ``forward(mic, far)`` is ``dccrn_apply`` in the module's
    mode (``train()`` / ``eval()``)."""

    apply_fn = dccrn_apply

    def __init__(self, params: dict, state: dict, cfg: DccrnConfig = DccrnConfig()):
        super().__init__(params, state, cfg)
