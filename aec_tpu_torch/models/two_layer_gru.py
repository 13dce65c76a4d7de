"""TwoLayerGRUNet, the alternative ERB-domain masking net (``aec_tpu/models/two_layer_gru.py``).

LittleNet's skeleton with a GRU(2E -> 2E), features ``[mic_erb || ref_erb]``
(plain concat, no difference), no skip concat before linear1 and no input
pseudo-norm. Loss: the compressed ERB-magnitude MSE, with the optional
asymmetric term. At E = 32 its GRU is 64 wide, so a CUDA call of 64 frames or
more runs it on kernel K8 at any batch, and its backward on K8b (``ops/gru``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.ops.gru import gru_init, gru_scan


class TwoLayerGru(nn.Module):
    def __init__(self, erb_bands: int = 32):
        super().__init__()
        self.gru = nn.GRU(2 * erb_bands, 2 * erb_bands, batch_first=True)
        self.linear1 = nn.Linear(2 * erb_bands, erb_bands)
        self.linear2 = nn.Linear(erb_bands, erb_bands)

    def gru_params(self) -> dict[str, torch.Tensor]:
        g = self.gru
        return {"w_ih": g.weight_ih_l0, "w_hh": g.weight_hh_l0,
                "b_ih": g.bias_ih_l0, "b_hh": g.bias_hh_l0}

    def forward(self, mic, ref, erb, cfg: StftConfig = StftConfig()):
        return two_layer_gru_apply(self, mic, ref, erb, cfg)


def two_layer_gru_init(erb_bands: int = 32, *, generator: torch.Generator | None = None,
                       device="cuda") -> TwoLayerGru:
    """The JAX package's init policy: orthogonal GRU weights with
    U(+-1/sqrt(H)) biases, linear1 kaiming-uniform with the ReLU gain
    sqrt(2), linear2 with gain 1, zero linear biases; drawn on the CPU from
    ``generator``, then moved to ``device``."""
    net = TwoLayerGru(erb_bands)
    gp = gru_init(2 * erb_bands, 2 * erb_bands, orthogonal=True, generator=generator,
                  device="cpu")
    with torch.no_grad():
        for name, p in net.gru_params().items():
            p.copy_(gp[name])
        for lin, gain in ((net.linear1, math.sqrt(2.0)), (net.linear2, 1.0)):
            bound = gain * math.sqrt(3.0 / lin.weight.shape[1])
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()
    return net.to(device)


def two_layer_gru_apply(net: TwoLayerGru, mic: torch.Tensor, ref: torch.Tensor,
                        erb: torch.Tensor, cfg: StftConfig = StftConfig(),
                        ) -> dict[str, torch.Tensor]:
    """mic/ref wav [B, n] -> ``wav`` [B, n], ``est_erb`` and ``mask`` [B, T, E]."""
    mic_spec = stft_mod.stft(mic, cfg)
    ref_spec = stft_mod.stft(ref, cfg)
    mic_erb = stft_mod.magnitude(mic_spec) @ erb
    ref_erb = stft_mod.magnitude(ref_spec) @ erb
    feats = torch.cat([mic_erb, ref_erb], dim=-1)

    out1, _ = gru_scan(net.gru_params(), feats)
    mask = torch.sigmoid(net.linear2(torch.relu(net.linear1(out1))))

    est_erb = mask * mic_erb
    gain = est_erb @ erb.T
    re, im = split_complex(mic_spec)
    out_spec = torch.cat([gain * re, gain * im], dim=-1)
    wav = stft_mod.istft(out_spec, cfg) + 1e-9
    return {"wav": wav, "est_erb": est_erb, "mask": mask}


def two_layer_gru_loss(net: TwoLayerGru, mic, ref, near, erb, cfg: StftConfig = StftConfig(), *,
                       asym_weight: float = 0.0, sqrt_eps: float = 0.0
                       ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Compressed ERB-magnitude MSE plus the optional asymmetric penalty;
    ``sqrt_eps`` guards the sqrt's gradient at 0, as in little_net_loss."""
    out = two_layer_gru_apply(net, mic, ref, erb, cfg)
    near_erb = stft_mod.magnitude(stft_mod.stft(near, cfg)) @ erb
    t, e = near_erb.shape[-2], near_erb.shape[-1]
    diff = torch.sqrt(near_erb + sqrt_eps) - torch.sqrt(out["est_erb"] + sqrt_eps)
    loss = torch.sum(diff * diff) / (t * e)
    if asym_weight:
        asym = torch.sum(torch.relu(diff) ** 2) / (t * e)
        loss = (1.0 - asym_weight) * loss + asym_weight * asym
    return loss, {"wav": out["wav"], "est_erb": out["est_erb"]}
