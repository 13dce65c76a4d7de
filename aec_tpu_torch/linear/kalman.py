"""Stage-1 linear AEC: partitioned-block frequency-domain Kalman filter
(counterpart of ``aec_tpu/linear/kalman.py``).

Per bin k, partitions l, diagonal covariance P[l,k] (real):

  predict:  W-  = a * W                       (echo-path drift model)
            P-  = a^2 * P + (1 - a^2) |W|^2 + q_min
  observe:  e   = d_block - last_B(ifft(sum_l W-[l] X[l]))
            psi = max(smoothed |E|^2, floor)  (observation-noise psd)
            den = sum_l |X[l]|^2 P-[l] + 2*psi
  update:   W   = W- + constrain(P-[l] conj(X[l]) E / den)
            P   = max(P- (1 - P- |X|^2 / den), floor)

Spectra and state are REAL ``[re || im]`` tensors (overlap_save.py). The
plain form is a Python loop over blocks, batched over every leading axis;
it is the plain version of the CUDA kernels in ``kernels/kalman.py``, which
:func:`kalman_cancel` takes for CUDA tensors.
"""

from __future__ import annotations

import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.linear import overlap_save as ols


def kalman_init(
    cfg: KalmanConfig, n_freqs: int = 257, *, batch_shape=(), device=None,
    dtype=torch.float32,
) -> dict[str, torch.Tensor]:
    """Zero filter, P = init_p, psi = psi_floor; leading ``batch_shape``."""
    lead = tuple(batch_shape)
    kw = {"device": device, "dtype": dtype}
    return {
        "w": torch.zeros(*lead, cfg.n_blocks, 2 * n_freqs, **kw),
        "p": torch.full((*lead, cfg.n_blocks, n_freqs), cfg.init_p, **kw),
        "x_buf": torch.zeros(*lead, cfg.n_blocks, 2 * n_freqs, **kw),
        "psi": torch.full((*lead, n_freqs), cfg.psi_floor, **kw),
    }


def kalman_step(
    cfg: KalmanConfig,
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
    a2 = cfg.a * cfg.a

    # predict
    wr, wi = ols.ri_split(state["w"])
    wr_p, wi_p = cfg.a * wr, cfg.a * wi
    p_pred = a2 * state["p"] + (1.0 - a2) * (wr * wr + wi * wi) + cfg.q_min

    # prior residual (overlap-save time domain), then its spectrum
    y_ri = ols.ri_join(
        torch.sum(wr_p * xr - wi_p * xi, dim=-2),
        torch.sum(wr_p * xi + wi_p * xr, dim=-2),
    )
    e_block = d_t - ols.spectrum_to_block(y_ri, block)
    er, ei = ols.ri_split(ols.block_to_spectrum(e_block, block))
    psi = cfg.obs_smooth * state["psi"] + (1.0 - cfg.obs_smooth) * (er * er + ei * ei)
    psi = torch.clamp_min(psi, cfg.psi_floor)

    # gain and update: upd = P- conj(X) E / den (complex, per partition)
    x_mag2 = xr * xr + xi * xi  # (..., L, K)
    den = torch.sum(x_mag2 * p_pred, dim=-2) + 2.0 * psi  # (..., K)
    er_d, ei_d = (er / den).unsqueeze(-2), (ei / den).unsqueeze(-2)
    upd = ols.ri_join(
        p_pred * (xr * er_d + xi * ei_d), p_pred * (xr * ei_d - xi * er_d)
    )
    if constrain:
        upd = ols.constrain_gradient(upd, block)
    w = ols.ri_join(wr_p, wi_p) + upd
    p = p_pred * (1.0 - p_pred * x_mag2 / den.unsqueeze(-2))
    p = torch.clamp_min(p, cfg.psi_floor)
    return {"w": w, "p": p, "x_buf": x_buf, "psi": psi}, e_block


def kalman_filter(
    cfg: KalmanConfig,
    x_spec: torch.Tensor,
    d_blocks: torch.Tensor,
    state: dict[str, torch.Tensor] | None = None,
    *,
    block: int = 256,
    constrain: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Filter sequences: far ri spectra [..., T, 2K], mic blocks [..., T, B]
    -> (e [..., T, B], final state). A Python loop over the T blocks from
    ``state`` (a filter resumed where an earlier call left it), or from
    :func:`kalman_init`'s state when it is None."""
    if state is None:
        state = kalman_init(
            cfg, x_spec.shape[-1] // 2, batch_shape=x_spec.shape[:-2],
            device=x_spec.device, dtype=x_spec.dtype,
        )
    e_blocks = torch.empty_like(d_blocks)
    for t in range(x_spec.shape[-2]):
        state, e_blocks[..., t, :] = kalman_step(
            cfg, state, x_spec[..., t, :], d_blocks[..., t, :], block=block,
            constrain=constrain,
        )
    return e_blocks, state


def kalman_cancel_plain(
    cfg: KalmanConfig, far: torch.Tensor, mic: torch.Tensor, *,
    block: int = 256, constrain: bool = True,
) -> dict[str, torch.Tensor]:
    """Waveform in/out on the plain loop: [..., n] -> {wav [..., n], state}."""
    n = mic.shape[-1]
    x_spec = ols.far_end_spectra(ols.pad_to_blocks(far, block), block)
    d_blocks = ols.mic_blocks(ols.pad_to_blocks(mic, block), block)
    e_blocks, state = kalman_filter(
        cfg, x_spec, d_blocks, block=block, constrain=constrain
    )
    return {"wav": e_blocks.flatten(-2)[..., :n], "state": state}


def kalman_cancel(
    cfg: KalmanConfig,
    far: torch.Tensor,
    mic: torch.Tensor,
    *,
    block: int = 256,
    constrain: bool = True,
    quality: str = "parity",
) -> dict[str, torch.Tensor]:
    """Waveform in/out canceller, [n] or [B, n].

    CUDA tensors run a CUDA kernel and return ``state=None``, as the JAX
    package's fused route does: a batch the batched kernel K1, a single
    utterance the single-stream cluster kernel K6 (``kernels/kalman.py``),
    as JAX routes 1-D calls to ``kalman_cancel_fused``. ``constrain=False``
    stays on the plain loop on every device, as JAX routes it to its scan.
    CPU tensors take the plain loop and return its final state. Every
    product is plain fp32, which meets the JAX ``"parity"`` tier;
    ``quality="fast"`` (JAX's mixed bf16 tier, which the port has no use
    for) computes the same fp32 numbers.
    """
    if quality not in ("parity", "fast"):
        raise ValueError(f"quality must be 'parity' or 'fast', got {quality!r}")
    if far.is_cuda and constrain:
        from aec_tpu_torch.kernels.kalman import kalman_cancel_fused, kalman_cancel_fused_batched

        fused = kalman_cancel_fused_batched if far.ndim == 2 else kalman_cancel_fused
        return {"wav": fused(cfg, far, mic, block=block)["wav"], "state": None}
    return kalman_cancel_plain(cfg, far, mic, block=block, constrain=constrain)
