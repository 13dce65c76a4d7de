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

Training objective (:func:`little_net_loss`): the compressed ERB-magnitude
MSE, summed over the batch and divided by T * bands only, as the reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.ops.gru import gru_init, gru_scan
from aec_tpu_torch.parallel import global_batch as gb
from aec_tpu_torch.utils.tools import num_params


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


# JAX's name for the param tree's type; the port's parameters are the module
LittleNetParams = LittleNet


def little_net_init(
    erb_bands: int = 32, width: int = 1, *, generator: torch.Generator | None = None,
    device="cuda",
) -> LittleNet:
    """A fresh ``LittleNet`` with the reference's init policy: orthogonal
    GRU weights with U(+-1/sqrt(H)) biases, linear1 kaiming-uniform with the
    ReLU gain sqrt(2), linear2 with gain 1, zero linear biases. Drawn on the
    CPU from ``generator`` (one seed, one net on every device), then moved
    to ``device``. ``width`` scales the GRU hidden and lin1 sizes."""
    net = LittleNet(erb_bands=erb_bands, width=width)
    gp = gru_init(2 * erb_bands, net.hidden, orthogonal=True, generator=generator, device="cpu")
    with torch.no_grad():
        for name, p in net.gru_params().items():
            p.copy_(gp[name])
        for lin, gain in ((net.linear1, math.sqrt(2.0)), (net.linear2, 1.0)):
            bound = gain * math.sqrt(3.0 / lin.weight.shape[1])  # kaiming_uniform_, fan_in
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()
    return net.to(device)


param_count = num_params  # total trainable parameters


def little_net_width(net: LittleNet, erb_bands: int = 32) -> int:
    """Width multiplier of a (possibly widened) LittleNet."""
    return net.gru1.weight_hh_l0.shape[-1] // erb_bands


def _pseudo_norm(x: torch.Tensor, per_utt: bool = False) -> torch.Tensor:
    """Subtract the scalar mean/std ratio (unbiased std), over the whole
    tensor or per utterance (last axis). A zero variance defines the ratio
    as 0 (the JAX package's documented 0/0 guard). In a data-parallel step
    (``parallel/global_batch.py``) the whole tensor is the global batch."""

    def _safe_ratio(mean, var):
        nz = var > 0.0
        std = torch.sqrt(torch.where(nz, var, torch.ones_like(var)))
        return torch.where(nz, mean / std, torch.zeros_like(mean))

    if per_utt:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.sum((x - mean) ** 2, dim=-1, keepdim=True) / (x.shape[-1] - 1)
        return x - _safe_ratio(mean, var)
    # over the whole batch: in a data-parallel step, the global batch's
    # (two passes, as JAX's: the mean first, then the squared deviations)
    mean = gb.mean(x)
    var = gb.all_sum(torch.sum((x - mean) ** 2)) / (gb.count(x.numel()) - 1)
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


def little_net_loss(
    net: LittleNet,
    mic: torch.Tensor,
    ref: torch.Tensor,
    near: torch.Tensor,
    erb: torch.Tensor,
    cfg: StftConfig = StftConfig(),
    *,
    normalize: bool = True,
    sqrt_eps: float = 0.0,
    asym_weight: float = 0.0,
    gain_norm: bool = False,
    sisnr_weight: float = 0.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training objective ``sum |near_erb^0.5 - est_erb^0.5|^2 / (T * E)``,
    summed over the batch -> (loss, {"wav", "est_erb"}).

    As ``aec_tpu.models.little_net.little_net_loss``: ``sqrt_eps`` inside
    the square roots (0 is exact parity; training passes 1e-12 so an
    estimate that underflows to 0 does not give an infinite gradient);
    ``asym_weight`` adds ``w * sum(relu(near^0.5 - est^0.5)^2) / (T * E)``,
    the penalty on removed near-end speech; ``gain_norm`` synthesizes the
    waveform through the convex gain; ``sisnr_weight`` subtracts ``w / 10``
    times the mean SI-SNR of the output against the near end over scenes
    whose raw near end is active.
    """
    # activity decided on the RAW near end: the pseudo-norm shifts a silent
    # scene to a constant that would otherwise count as active
    near_act = (torch.mean(near * near, dim=-1) > 1e-8).to(torch.float32)
    if normalize:
        mic, ref, near = _pseudo_norm(mic), _pseudo_norm(ref), _pseudo_norm(near)
    out = little_net_apply(net, mic, ref, erb, cfg, normalize=False, gain_norm=gain_norm)
    near_erb = stft_mod.magnitude(stft_mod.stft(near, cfg)) @ erb  # [B, T, E]
    t, e = near_erb.shape[-2], near_erb.shape[-1]
    diff = torch.sqrt(near_erb + sqrt_eps) - torch.sqrt(out["est_erb"] + sqrt_eps)
    loss = torch.sum(diff * diff) / (t * e)
    if asym_weight:
        under = torch.relu(diff)  # near above the estimate: removed near end
        loss = loss + asym_weight * torch.sum(under * under) / (t * e)
    if sisnr_weight:
        from aec_tpu_torch.train.metrics import si_snr_rows

        per = si_snr_rows(out["wav"][..., : near.shape[-1]], near)
        # over the active scenes of the global batch in a data-parallel step
        mean_db = torch.sum(per * near_act) / torch.clamp_min(gb.all_sum(torch.sum(near_act)), 1.0)
        loss = loss - sisnr_weight * mean_db / 10.0
    return loss, {"wav": out["wav"], "est_erb": out["est_erb"]}
