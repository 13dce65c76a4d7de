"""FullSubNet-style dual-mask AEC model (``aec_tpu/models/fullsubnet.py``).

The reference training script's contract (scripts/models.py): STFT 320/160,
an optional 21-filter mel bank on the full-band input, dual masks
``mask_near, mask_echo = net(mic_mag, ref_mag)`` applied to the mic
magnitude with the mic phase; training is a complex-spectrum MSE against the
near end. The structure is the published FullSubNet (Hao et al., ICASSP
2021): a full-band LSTM over the whole magnitude spectrum emits a per-bin
embedding; a sub-band LSTM shared by all bins runs per bin over [the bin's
neighbourhood of mic and far magnitudes || the embedding].

``fullsubnet_masks(fused=True)`` runs both LSTMs in one recurrence over
frames (the full-band step of a frame feeds the sub-band step of the same
frame). On a CUDA tensor that joint recurrence is kernel K11
(``kernels/fullsubnet.py``); its plain version is :func:`_joint_scan_hs`,
one frame per loop iteration, fp32 on every device (JAX rounds the
recurrent weights to bf16 only on the TPU). JAX leaves its TPU kernel for
this recurrence unrouted (it measured slower than XLA's unrolled scan); in
the port the alternative to K11 is a chain of launches per frame, so a CUDA
tensor takes the kernel, and ``chip_smoke.py`` times both side by side.

The functions keep the JAX package's names and signatures on dicts of
tensors; :class:`FullSubNet` holds the same tree as a module.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig, split_complex
from aec_tpu_torch.models.tree_net import TreeNet
from aec_tpu_torch.ops.lstm import lstm_gates, lstm_init, lstm_scan


@dataclasses.dataclass(frozen=True)
class FullSubNetConfig:
    stft: StftConfig = StftConfig(win_len=320, hop=160, fft_len=320)
    fb_hidden: int = 256
    sb_hidden: int = 96
    neighborhood: int = 5  # sub-band context: +-neighborhood bins
    # mel-filterbank energies appended to the full-band input (models.py:117,192)
    use_mel: bool = False
    mel_filters: int = 21

    @property
    def n_freqs(self) -> int:
        return self.stft.n_freqs  # 161

    @property
    def fb_input(self) -> int:
        return 2 * self.n_freqs + (2 * self.mel_filters if self.use_mel else 0)

    @property
    def sb_input(self) -> int:
        # per bin: mic neighbourhood + far neighbourhood + the fb embedding
        return 2 * (2 * self.neighborhood + 1) + 1


def fullsubnet_init(cfg: FullSubNetConfig = FullSubNetConfig(), *,
                    generator: torch.Generator | None = None, device="cuda") -> dict:
    """The param tree: two LSTMs (torch's init) and two linear heads
    (U(-1/sqrt(in), 1/sqrt(in)) weights, zero biases). Drawn on the CPU from
    ``generator`` (JAX draws its own numbers from its key), then moved."""
    f = cfg.n_freqs

    def linear(i, o):
        bound = 1.0 / math.sqrt(i)
        w = torch.empty(o, i).uniform_(-bound, bound, generator=generator)
        return {"w": w.to(device), "b": torch.zeros(o, device=device)}

    return {
        "fb_lstm": lstm_init(cfg.fb_input, cfg.fb_hidden, generator=generator, device=device),
        "fb_out": linear(cfg.fb_hidden, f),
        "sb_lstm": lstm_init(cfg.sb_input, cfg.sb_hidden, generator=generator, device=device),
        "sb_out": linear(cfg.sb_hidden, 2),  # (mask_near, mask_echo)
    }


def _unfold_bins(mag: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, F] -> [B, T, F, 2n+1] reflect-padded frequency neighbourhoods."""
    padded = F.pad(mag, (n, n), mode="reflect")
    f = mag.shape[-1]
    return torch.stack([padded[..., i: i + f] for i in range(2 * n + 1)], dim=-1)


def _fb_input(mic_mag: torch.Tensor, ref_mag: torch.Tensor, cfg: FullSubNetConfig):
    parts = [mic_mag, ref_mag]
    if cfg.use_mel:
        from aec_tpu_torch.dsp.mel import mel_filterbank

        mel = torch.as_tensor(mel_filterbank(cfg.mel_filters, cfg.stft.fft_len),
                              dtype=mic_mag.dtype, device=mic_mag.device)
        parts += [mic_mag @ mel, ref_mag @ mel]
    return torch.cat(parts, dim=-1)  # [B, T, fb_input]


def fullsubnet_masks(params: dict, mic_mag: torch.Tensor, ref_mag: torch.Tensor,
                     cfg: FullSubNetConfig = FullSubNetConfig(), *, fused: bool = True,
                     joint_kernel: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitudes [B, T, F] -> (mask_near, mask_echo) in [0, 1]^[B, T, F].

    ``fused=True`` runs both LSTM stages in one recurrence over frames; the
    sub-band input projection splits into the hoisted neighbourhood columns
    and the in-loop embedding column (the same sums re-associated, ~1e-6
    from the two-scan form). ``fused=False`` is the reference-shaped two-scan
    composition. ``joint_kernel`` (fused only): None takes K11 on a CUDA
    tensor through its autograd Function (the plain version on a CPU
    tensor); False runs the plain joint loop on any device."""
    b, t, f = mic_mag.shape
    fb_in = _fb_input(mic_mag, ref_mag, cfg)
    n = cfg.neighborhood
    nb = 2 * (2 * n + 1)  # the hoistable neighbourhood columns of the sub-band input
    sb_nb = torch.cat([_unfold_bins(mic_mag, n), _unfold_bins(ref_mag, n)], dim=-1)
    if not fused:
        fb_seq, _ = lstm_scan(params["fb_lstm"], fb_in)
        fb_emb = torch.relu(fb_seq @ params["fb_out"]["w"].T + params["fb_out"]["b"])
        sb_in = torch.cat([sb_nb, fb_emb[..., None]], dim=-1)
        sb_in = sb_in.permute(0, 2, 1, 3).reshape(b * f, t, cfg.sb_input)
        sb_seq, _ = lstm_scan(params["sb_lstm"], sb_in)  # [B*F, T, H]
        masks = torch.sigmoid(sb_seq @ params["sb_out"]["w"].T + params["sb_out"]["b"])
        masks = masks.reshape(b, f, t, 2).permute(0, 2, 1, 3)  # [B, T, F, 2]
        return masks[..., 0], masks[..., 1]

    # the hoisted input projections, both biases of each LSTM folded in
    fb_p, sb_p = params["fb_lstm"], params["sb_lstm"]
    xp_fb = torch.matmul(fb_in, fb_p["w_ih"].T) + fb_p["b_ih"] + fb_p["b_hh"]  # [B, T, 4Hfb]
    xp_sb = (torch.matmul(sb_nb, sb_p["w_ih"][:, :nb].T)
             + sb_p["b_ih"] + sb_p["b_hh"])  # [B, T, F, 4Hsb]
    if joint_kernel is False:
        hs_seq = _joint_scan_hs(params, xp_fb, xp_sb)
    else:
        from aec_tpu_torch.kernels.fullsubnet import fsn_joint_fused

        hs_seq = fsn_joint_fused(params, xp_fb, xp_sb)  # [B, T, F, Hsb]
    masks = torch.sigmoid(hs_seq @ params["sb_out"]["w"].T + params["sb_out"]["b"])
    return masks[..., 0], masks[..., 1]


def _joint_scan_hs(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """The joint full -> sub recurrence on the hoisted projections (every
    bias already in ``xp_*``): ([B, T, 4Hfb], [B, T, F, 4Hsb]) -> the
    sub-band hidden sequence [B, T, F, Hsb], one frame per loop iteration,
    from zero state. K11's plain version, and what its backward recomputes."""
    fb_p, sb_p = params["fb_lstm"], params["sb_lstm"]
    b, t, four_hfb = xp_fb.shape
    f, four_hsb = xp_sb.shape[2], xp_sb.shape[3]
    h_fb, h_sb = four_hfb // 4, four_hsb // 4
    w_fb_col = sb_p["w_ih"][:, -1]  # (4Hsb,): the fb-embedding column
    w_hh_fb, w_hh_sb = fb_p["w_hh"].T, sb_p["w_hh"].T
    hf = cf = xp_fb.new_zeros((b, h_fb))
    hs = cs = xp_fb.new_zeros((b * f, h_sb))
    out = []
    for i in range(t):
        hf, cf = lstm_gates(xp_fb[:, i] + hf @ w_hh_fb, cf)
        emb = torch.relu(hf @ params["fb_out"]["w"].T + params["fb_out"]["b"])  # [B, F]
        sb_x = (xp_sb[:, i] + emb[..., None] * w_fb_col).reshape(b * f, four_hsb)
        hs, cs = lstm_gates(sb_x + hs @ w_hh_sb, cs)
        out.append(hs.reshape(b, f, h_sb))
    return torch.stack(out, dim=1) if out else xp_sb.new_zeros((b, 0, f, h_sb))


def fullsubnet_apply(params: dict, mic: torch.Tensor, ref: torch.Tensor,
                     cfg: FullSubNetConfig = FullSubNetConfig(), *,
                     joint_kernel: bool | None = None) -> dict[str, torch.Tensor]:
    """wav [B, n] -> the dual-mask enhancement (models.py:417-443): the near
    estimate is mask_near * |mic| with the mic phase, the echo estimate the
    same with mask_echo. ``joint_kernel`` as in :func:`fullsubnet_masks`."""
    scfg = cfg.stft
    mic_spec = stft_mod.stft(mic, scfg)
    mic_mag = stft_mod.magnitude(mic_spec)
    ref_mag = stft_mod.magnitude(stft_mod.stft(ref, scfg))
    mask_near, mask_echo = fullsubnet_masks(params, mic_mag, ref_mag, cfg,
                                            joint_kernel=joint_kernel)
    re, im = split_complex(mic_spec)
    phase = torch.atan2(im, re)
    cos, sin = torch.cos(phase), torch.sin(phase)
    est_mag = mask_near * mic_mag
    est = torch.cat([est_mag * cos, est_mag * sin], dim=-1)
    echo_mag = mask_echo * mic_mag
    echo_spec = torch.cat([echo_mag * cos, echo_mag * sin], dim=-1)
    return {"wav": stft_mod.istft(est, scfg), "echo_wav": stft_mod.istft(echo_spec, scfg),
            "mask_near": mask_near, "mask_echo": mask_echo, "out_spec": est}


def fullsubnet_loss(params: dict, mic, ref, near, echo,
                    cfg: FullSubNetConfig = FullSubNetConfig()) -> tuple[torch.Tensor, dict]:
    """Complex-spectrum MSE against the near end (models.py:195-197) plus the
    echo-mask term of the dual-mask contract."""
    out = fullsubnet_apply(params, mic, ref, cfg)
    scfg = cfg.stft
    re, im = split_complex(out["out_spec"])
    nre, nim = split_complex(stft_mod.stft(near, scfg))
    loss_near = torch.mean((re - nre) ** 2) + torch.mean((im - nim) ** 2)
    mic_mag = stft_mod.magnitude(stft_mod.stft(mic, scfg))
    echo_mag_t = stft_mod.magnitude(stft_mod.stft(echo, scfg))
    loss_echo = torch.mean((out["mask_echo"] * mic_mag - echo_mag_t) ** 2)
    return loss_near + loss_echo, {"wav": out["wav"]}


class FullSubNet(TreeNet):
    """FullSubNet holding ``fullsubnet_init``'s param tree (``self.net``; no
    running statistics). ``forward(mic, far)`` is ``fullsubnet_apply``."""

    def __init__(self, params: dict, cfg: FullSubNetConfig = FullSubNetConfig()):
        super().__init__(params, {}, cfg)

    def forward(self, mic: torch.Tensor, far: torch.Tensor) -> dict:
        return fullsubnet_apply(self.params(), mic, far, self.cfg)
