"""Evaluation metrics: SI-SNR, ERLE, segmental ERLE, SNR
(``aec_tpu/train/metrics.py``), with the epsilons in the same places."""

from __future__ import annotations

import torch


def si_snr_rows(est: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB of each row (last axis), no DC removal:
    est is projected onto target, ``s = <est, t> / (<t, t> + eps) * t``."""
    dot = torch.sum(est * target, dim=-1, keepdim=True)
    t_energy = torch.sum(target * target, dim=-1, keepdim=True)
    s_target = dot / (t_energy + eps) * target
    e_noise = est - s_target
    num = torch.sum(s_target * s_target, dim=-1)
    den = torch.sum(e_noise * e_noise, dim=-1)
    return 10.0 * torch.log10(num / (den + eps) + eps)


def si_snr(est: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB, mean over leading dims."""
    return torch.mean(si_snr_rows(est, target, eps))


def erle(mic: torch.Tensor, residual: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Echo return loss enhancement in dB, 10 log10(E[mic^2] / E[res^2]) over
    the last axis, mean over leading dims."""
    num = torch.mean(mic * mic, dim=-1)
    den = torch.mean(residual * residual, dim=-1)
    return torch.mean(10.0 * torch.log10((num + eps) / (den + eps)))


def erle_segments(mic: torch.Tensor, residual: torch.Tensor, seg: int = 4096,
                  eps: float = 1e-12) -> torch.Tensor:
    """Per-segment ERLE curve [..., n // seg] (convergence diagnostics)."""
    n = mic.shape[-1] // seg * seg
    m = mic[..., :n].reshape(*mic.shape[:-1], -1, seg)
    r = residual[..., :n].reshape(*residual.shape[:-1], -1, seg)
    return 10.0 * torch.log10((torch.mean(m * m, dim=-1) + eps) / (torch.mean(r * r, dim=-1) + eps))


def snr(est: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Plain SNR in dB against a known clean target."""
    num = torch.sum(target * target, dim=-1)
    den = torch.sum((est - target) ** 2, dim=-1)
    return torch.mean(10.0 * torch.log10((num + eps) / (den + eps)))
