"""Batched feature extraction on the device (``aec_tpu/pipeline/features.py``).

The wav -> feature map over a batch of utterances: STFT spectra, ERB
energies and LittleNet's GRU input, computed on the tensors' device (the
card unless the caller passes CPU tensors); :func:`extract_features_chunked`
streams an (N, n) corpus through it in bounded chunks and returns numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig


def extract_features(
    mic: torch.Tensor,
    ref: torch.Tensor,
    near: torch.Tensor,
    erb: torch.Tensor,
    cfg: StftConfig = StftConfig(),
) -> dict[str, torch.Tensor]:
    """[B, n] wav triple -> feature and label tensors on the inputs' device.

    Returns ``mic_spec`` / ``ref_spec`` / ``near_spec`` [B, T, 2K]
    (real || imag), ``mic_erb`` and ``near_erb`` [B, T, E] (the training
    label), ``gru_input`` [B, T, 2E] (LittleNet's features)."""
    mic_spec = stft_mod.stft(mic, cfg)
    ref_spec = stft_mod.stft(ref, cfg)
    near_spec = stft_mod.stft(near, cfg)
    mic_erb = stft_mod.magnitude(mic_spec) @ erb
    ref_erb = stft_mod.magnitude(ref_spec) @ erb
    near_erb = stft_mod.magnitude(near_spec) @ erb
    gru_input = torch.cat([mic_erb, torch.abs(mic_erb - ref_erb)], dim=-1)
    return {
        "mic_spec": mic_spec,
        "ref_spec": ref_spec,
        "near_spec": near_spec,
        "mic_erb": mic_erb,
        "near_erb": near_erb,
        "gru_input": gru_input,
    }


@torch.no_grad()
def extract_features_chunked(
    mic: np.ndarray,
    ref: np.ndarray,
    near: np.ndarray,
    cfg: StftConfig = StftConfig(),
    *,
    erb_bands: int = 32,
    chunk: int = 256,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Host driver: [N, n] numpy arrays through :func:`extract_features` on
    ``device`` in ``chunk``-row batches (bounded device memory), gathered on
    the host as numpy."""
    erb = torch.as_tensor(erb_filterbank(cfg.n_freqs, 16000, erb_bands), device=device)
    outs: list[dict] = []
    for lo in range(0, mic.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        out = extract_features(*(torch.as_tensor(a[sl], device=device) for a in (mic, ref, near)),
                               erb, cfg)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
