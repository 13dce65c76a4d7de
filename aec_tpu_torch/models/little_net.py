"""LittleNet — the ERB-domain residual-echo-suppression post-filter
(counterpart of ``aec_tpu/models/little_net.py``).

GRU(64->32) + Linear(64->32) + Linear(32->32), ~12.5k parameters, with the
reference's submodule names (``gru1``, ``linear1``, ``linear2``) so the
state dict reads like the reference's. Forward contract, quirks preserved:

1. optional global scalar pseudo-norm ``x - mean(x)/std(x)`` (unbiased std);
2. STFT of mic/ref (512/256 hann, both-side pad);
3. magnitudes with in-sqrt 1e-9 epsilon; ERB projection ``mag @ erb``;
4. features ``[mic_erb || |mic_erb - ref_erb|]``;
5. GRU -> concat with mic_erb -> Linear+ReLU -> Linear+Sigmoid = mask;
6. ``est_erb = mask * mic_erb``; back-projection ``est_erb @ erb.T`` (divided
   by the unmasked back-projection with ``gain_norm``); the SAME gain
   multiplies real and imaginary parts;
7. iSTFT + 1e-9.
"""

from __future__ import annotations

import torch
from torch import nn

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.ops.gru import gru_scan


class LittleNet(nn.Module):
    """Width-``width`` LittleNet; ``width=1`` is the reference geometry
    (GRU hidden == ERB bands). Wider nets run the same forward."""

    def __init__(self, erb_bands: int = 32, width: int = 1):
        super().__init__()
        hidden = width * erb_bands
        self.gru1 = nn.GRU(2 * erb_bands, hidden, batch_first=True)
        self.linear1 = nn.Linear(hidden + erb_bands, hidden)
        self.linear2 = nn.Linear(hidden, erb_bands)

    @property
    def hidden(self) -> int:
        return self.gru1.hidden_size

    def gru_params(self) -> dict[str, torch.Tensor]:
        g = self.gru1
        return {"w_ih": g.weight_ih_l0, "w_hh": g.weight_hh_l0,
                "b_ih": g.bias_ih_l0, "b_hh": g.bias_hh_l0}

    def forward(self, mic, ref, erb, cfg: StftConfig = StftConfig(), **kw):
        return little_net_apply(self, mic, ref, erb, cfg, **kw)


def _pseudo_norm(x: torch.Tensor, per_utt: bool = False) -> torch.Tensor:
    """Subtract the scalar mean/std ratio (unbiased std), over the whole
    tensor or per utterance (last axis). A zero variance defines the ratio
    as 0 (the JAX package's documented 0/0 guard)."""

    def _safe_ratio(mean, var):
        nz = var > 0.0
        std = torch.sqrt(torch.where(nz, var, torch.ones_like(var)))
        return torch.where(nz, mean / std, torch.zeros_like(mean))

    if per_utt:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.sum((x - mean) ** 2, dim=-1, keepdim=True) / (x.shape[-1] - 1)
        return x - _safe_ratio(mean, var)
    mean = torch.mean(x)
    var = torch.sum((x - mean) ** 2) / (x.numel() - 1)
    return x - _safe_ratio(mean, var)


def little_net_features(
    mic: torch.Tensor, ref: torch.Tensor, erb: torch.Tensor, cfg: StftConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared feature path: (gru_input [B,T,2E], mic_erb [B,T,E], mic_spec)."""
    mic_spec = stft_mod.stft(mic, cfg)  # [B, T, 2K]
    ref_spec = stft_mod.stft(ref, cfg)
    mic_erb = stft_mod.magnitude(mic_spec) @ erb  # [B, T, E]
    ref_erb = stft_mod.magnitude(ref_spec) @ erb
    feats = torch.cat([mic_erb, torch.abs(mic_erb - ref_erb)], dim=-1)
    return feats, mic_erb, mic_spec


def little_net_apply(
    net: LittleNet,
    mic: torch.Tensor,
    ref: torch.Tensor,
    erb: torch.Tensor,
    cfg: StftConfig = StftConfig(),
    *,
    normalize: bool = True,
    per_utt_norm: bool = False,
    gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """Offline forward: mic/ref wav [B, n] -> ``wav`` [B, n], ``est_erb``
    [B, T, E], ``mask`` [B, T, E], ``mic_spec``. Plain fp32 on any device
    (the JAX package's ``precision=HIGHEST``)."""
    if normalize:
        mic = _pseudo_norm(mic, per_utt_norm)
        ref = _pseudo_norm(ref, per_utt_norm)
    feats, mic_erb, mic_spec = little_net_features(mic, ref, erb, cfg)

    out1, _ = gru_scan(net.gru_params(), feats)  # [B, T, H]
    hid = torch.cat([out1, mic_erb], dim=-1)
    hid = torch.relu(net.linear1(hid))
    mask = torch.sigmoid(net.linear2(hid))

    est_erb = mask * mic_erb
    gain = est_erb @ erb.T  # un-normalized back-projection
    if gain_norm:
        gain = gain / (mic_erb @ erb.T + 1e-9)
    re, im = split_complex(mic_spec)
    out_spec = torch.cat([gain * re, gain * im], dim=-1)
    wav = stft_mod.istft(out_spec, cfg) + 1e-9
    return {"wav": wav, "est_erb": est_erb, "mask": mask, "mic_spec": mic_spec}
