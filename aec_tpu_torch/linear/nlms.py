"""Stage-1 linear AEC: partitioned-block frequency-domain NLMS (MDF)
(counterpart of ``aec_tpu/linear/nlms.py``).

Per bin k, partitions l:

  power = power_smooth * power + (1 - power_smooth) * sum_l |X[l]|^2
  e     = d_block - last_B(ifft(sum_l W[l] X[l]))
  psi   = err_smooth * psi + (1 - err_smooth) |E|^2
  den   = power + eps + eps_rel * mean_k(power) + beta * psi
  W[l] += mu * constrain(conj(X[l]) E / den)

There is no predict step and no covariance; the denominator's mean over
the bins is the one reduction across bins besides the transforms.
Spectra and state are REAL ``[re || im]`` tensors (overlap_save.py). The
plain form is a Python loop over blocks, batched over every leading axis;
it is the plain version of the CUDA kernels in ``kernels/nlms.py``, which
:func:`nlms_cancel` takes for CUDA tensors.
"""

from __future__ import annotations

import torch

from aec_tpu_torch.configs import NlmsConfig
from aec_tpu_torch.linear import overlap_save as ols


def nlms_init(
    cfg: NlmsConfig, n_freqs: int = 257, *, batch_shape=(), device=None,
    dtype=torch.float32,
) -> dict[str, torch.Tensor]:
    """Zero filter, far-end history, power and psi; leading ``batch_shape``."""
    lead = tuple(batch_shape)
    kw = {"device": device, "dtype": dtype}
    return {
        "w": torch.zeros(*lead, cfg.n_blocks, 2 * n_freqs, **kw),
        "x_buf": torch.zeros(*lead, cfg.n_blocks, 2 * n_freqs, **kw),
        "power": torch.zeros(*lead, n_freqs, **kw),
        "psi": torch.zeros(*lead, n_freqs, **kw),
    }


def nlms_step(
    cfg: NlmsConfig,
    state: dict[str, torch.Tensor],
    x_t: torch.Tensor,
    d_t: torch.Tensor,
    *,
    block: int = 256,
    constrain: bool = True,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One block update: far ri spectrum [..., 2K], mic block [..., B] ->
    (new state, e [..., B])."""
    x_buf = torch.cat([x_t.unsqueeze(-2), state["x_buf"][..., :-1, :]], dim=-2)
    xr, xi = ols.ri_split(x_buf)  # (..., L, K)
    inst_power = torch.sum(xr * xr + xi * xi, dim=-2)
    power = cfg.power_smooth * state["power"] + (1.0 - cfg.power_smooth) * inst_power

    wr, wi = ols.ri_split(state["w"])
    y_ri = ols.ri_join(
        torch.sum(wr * xr - wi * xi, dim=-2), torch.sum(wr * xi + wi * xr, dim=-2)
    )
    e_block = d_t - ols.spectrum_to_block(y_ri, block)
    er, ei = ols.ri_split(ols.block_to_spectrum(e_block, block))
    psi = cfg.err_smooth * state["psi"] + (1.0 - cfg.err_smooth) * (er * er + ei * ei)

    # conj(X) E / den with the robustness terms, incl. the mean over bins
    den = (
        power + cfg.eps + cfg.eps_rel * torch.mean(power, dim=-1, keepdim=True)
        + cfg.beta * psi
    )
    inv_p = (1.0 / den).unsqueeze(-2)
    er_, ei_ = er.unsqueeze(-2), ei.unsqueeze(-2)
    grad = ols.ri_join((xr * er_ + xi * ei_) * inv_p, (xr * ei_ - xi * er_) * inv_p)
    if constrain:
        grad = ols.constrain_gradient(grad, block)
    w = state["w"] + cfg.mu * grad
    return {"w": w, "x_buf": x_buf, "power": power, "psi": psi}, e_block


def nlms_filter(
    cfg: NlmsConfig,
    x_spec: torch.Tensor,
    d_blocks: torch.Tensor,
    *,
    block: int = 256,
    constrain: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Filter sequences: far ri spectra [..., T, 2K], mic blocks [..., T, B]
    -> (e [..., T, B], final state). A Python loop over the T blocks from
    :func:`nlms_init`'s state."""
    state = nlms_init(
        cfg, x_spec.shape[-1] // 2, batch_shape=x_spec.shape[:-2],
        device=x_spec.device, dtype=x_spec.dtype,
    )
    e_blocks = torch.empty_like(d_blocks)
    for t in range(x_spec.shape[-2]):
        state, e_blocks[..., t, :] = nlms_step(
            cfg, state, x_spec[..., t, :], d_blocks[..., t, :], block=block,
            constrain=constrain,
        )
    return e_blocks, state


def nlms_cancel_plain(
    cfg: NlmsConfig, far: torch.Tensor, mic: torch.Tensor, *,
    block: int = 256, constrain: bool = True,
) -> dict[str, torch.Tensor]:
    """Waveform in/out on the plain loop: [..., n] -> {wav [..., n], state}."""
    n = mic.shape[-1]
    x_spec = ols.far_end_spectra(ols.pad_to_blocks(far, block), block)
    d_blocks = ols.mic_blocks(ols.pad_to_blocks(mic, block), block)
    e_blocks, state = nlms_filter(cfg, x_spec, d_blocks, block=block, constrain=constrain)
    return {"wav": e_blocks.flatten(-2)[..., :n], "state": state}


def nlms_cancel(
    cfg: NlmsConfig,
    far: torch.Tensor,
    mic: torch.Tensor,
    *,
    block: int = 256,
    constrain: bool = True,
    quality: str = "parity",
) -> dict[str, torch.Tensor]:
    """Waveform in/out canceller, [n] or [B, n].

    CUDA tensors run a CUDA kernel and return ``state=None``, as the JAX
    package's fused route does: a batch the batched kernel K5, a single
    utterance the single-stream cluster kernel K7 (``kernels/nlms.py``).
    ``constrain=False`` stays on the plain loop on every device, as JAX
    routes it to its scan. CPU tensors take the plain loop and return its
    final state. ``quality="parity"`` and ``"fast"`` route and compute
    identically: JAX allows NLMS no mixed tier (its constraint's rounding
    costs 18-26 dB on deep-converging scenes), and every product here is
    plain fp32.
    """
    if quality not in ("parity", "fast"):
        raise ValueError(f"quality must be 'parity' or 'fast', got {quality!r}")
    if far.is_cuda and constrain:
        from aec_tpu_torch.kernels.nlms import nlms_cancel_fused, nlms_cancel_fused_batched

        fused = nlms_cancel_fused_batched if far.ndim == 2 else nlms_cancel_fused
        return {"wav": fused(cfg, far, mic, block=block)["wav"], "state": None}
    return nlms_cancel_plain(cfg, far, mic, block=block, constrain=constrain)
