"""Complex-valued conv/norm building blocks of DCCRN (``aec_tpu/ops/complex_layers.py``).

The port keeps the JAX package's layouts at every function here: activations
are [B, F, T, C] (frequency and time spatial, channels last) with the
channel axis holding [real_channels || imag_channels], and conv kernels are
HWIO (kh, kw, Cin/2, Cout/2) per real/imaginary part. So a JAX parameter
tree carries over leaf for leaf. The convolutions run as
``torch.nn.functional.conv2d`` / ``conv_transpose2d`` on a channels-first
view (JAX computes them outside any Pallas kernel, so a library convolution
is their counterpart here).

A complex conv with kernels (Wr, Wi) applied to x = xr + i xi is
    yr = conv(xr, Wr) - conv(xi, Wi)
    yi = conv(xr, Wi) + conv(xi, Wr)
which is ONE real convolution of [xr || xi] with the block kernel
[[Wr, Wi], [-Wi, Wr]] (input rows, output columns) giving [yr || yi].

On the card cuDNN computes fp32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; a comparison with the fp32
reference pins it off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aec_tpu_torch.parallel import global_batch as gb


def complex_conv_init(c_in: int, c_out: int, kernel, *, generator=None,
                      device="cuda") -> dict[str, torch.Tensor]:
    """N(0, 0.05) weights and zero biases; ``c_in`` / ``c_out`` are the
    TOTAL (real + imaginary) channel counts, as in the reference's
    constructor. Drawn on the CPU from ``generator``, then moved."""
    kh, kw = kernel
    shape = (kh, kw, c_in // 2, c_out // 2)
    w_r = 0.05 * torch.randn(shape, generator=generator)
    w_i = 0.05 * torch.randn(shape, generator=generator)
    params = {"w_r": w_r, "w_i": w_i, "b_r": torch.zeros(c_out // 2),
              "b_i": torch.zeros(c_out // 2)}
    return {k: v.to(device) for k, v in params.items()}


def _split_ri(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = x.shape[-1] // 2
    return x[..., :c], x[..., c:]


def _block_kernel(params: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The real HWIO kernel (kh, kw, Cin, Cout) of the complex conv and its
    bias [b_r || b_i]."""
    w_real = torch.cat([params["w_r"], -params["w_i"]], dim=2)
    w_imag = torch.cat([params["w_i"], params["w_r"]], dim=2)
    return torch.cat([w_real, w_imag], dim=3), torch.cat([params["b_r"], params["b_i"]])


def _pairs(padding) -> list[tuple[int, int]]:
    """JAX's padding spelling (an int per spatial dim, or a (low, high)
    pair) as pairs."""
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def conv(p: dict[str, torch.Tensor], x: torch.Tensor, stride, padding) -> torch.Tensor:
    """A real conv: x NHWC, kernel ``p["w"]`` HWIO, bias ``p["b"]``,
    padding per spatial dim as JAX spells it."""
    (hl, hh), (wl, wh) = _pairs(padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (wl, wh, hl, hh))  # NCHW, (W, H) pads
    y = F.conv2d(xc, p["w"].permute(3, 2, 0, 1), p["b"], stride=tuple(stride))
    return y.permute(0, 2, 3, 1)


def conv_transpose(p: dict[str, torch.Tensor], x: torch.Tensor, stride, padding,
                   output_padding) -> torch.Tensor:
    """A real transposed conv with torch ConvTranspose2d's geometry:
    out = (in - 1) * stride - 2 * pad + kernel + output_padding. JAX writes
    it as an lhs-dilated conv of the flipped kernel with pads
    (k - 1 - p, k - 1 - p + output_padding); ``conv_transpose2d`` with the
    unflipped kernel laid out (Cin, Cout, kh, kw) is the same operator."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].permute(2, 3, 0, 1), p["b"],
                           stride=tuple(stride), padding=tuple(padding),
                           output_padding=tuple(output_padding))
    return y.permute(0, 2, 3, 1)


def complex_conv(params: dict[str, torch.Tensor], x: torch.Tensor, stride,
                 padding) -> torch.Tensor:
    """x [B, F, T, 2Cc] -> [B, F', T', 2Cc_out]; padding per spatial dim."""
    w, b = _block_kernel(params)
    return conv({"w": w, "b": b}, x, stride, padding)


def complex_conv_transpose(params: dict[str, torch.Tensor], x: torch.Tensor, stride,
                           padding, output_padding) -> torch.Tensor:
    """Transposed complex conv (:func:`conv_transpose` of the block kernel)."""
    w, b = _block_kernel(params)
    return conv_transpose({"w": w, "b": b}, x, stride, padding, output_padding)


def complex_cat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate keeping the [reals || imags] channel order."""
    parts = [_split_ri(t) for t in tensors]
    return torch.cat([r for r, _ in parts] + [i for _, i in parts], dim=-1)


def batch_norm_init(c: int, *, device="cuda"):
    """(params {scale, bias}, state {mean, var}) of a real BatchNorm."""
    params = {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}
    state = {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}
    return params, state


def batch_norm(params, state, x: torch.Tensor, *, train: bool, momentum: float = 0.1,
               eps: float = 1e-5):
    """Plain real BatchNorm over all non-channel axes; torch running-stat
    semantics (unbiased variance in the stats). Returns (y, new_state). In
    a data-parallel step (``parallel/global_batch.py``) the statistics and
    the count are the global batch's, the gradient flowing through them."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = gb.mean(x, dim=axes)
        var = gb.mean((x - mean) ** 2, dim=axes)
        count = gb.count(x.numel() // x.shape[-1])
        unbiased = var * count / max(count - 1, 1)
        new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean,
                     "var": (1 - momentum) * state["var"] + momentum * unbiased}
    else:
        mean, var, new_state = state["mean"], state["var"], state
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new_state


def prelu_init(*, device="cuda") -> torch.Tensor:
    """torch nn.PReLU() default: one shared slope, 0.25."""
    return torch.tensor(0.25, device=device)


def prelu(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def complex_batch_norm_init(c: int, *, generator=None, device="cuda"):
    """Whitening complex BN: per complex channel a 2x2 affine W (Wrr = Wii =
    1, Wri ~ U(-0.9, 0.9)) and a complex bias; running complex mean and 2x2
    covariance. ``c`` is the TOTAL channel count (real + imaginary)."""
    cc = c // 2
    w_ri = torch.empty(cc).uniform_(-0.9, 0.9, generator=generator)
    params = {"w_rr": torch.ones(cc), "w_ri": w_ri, "w_ii": torch.ones(cc),
              "b_r": torch.zeros(cc), "b_i": torch.zeros(cc)}
    state = {"m_r": torch.zeros(cc), "m_i": torch.zeros(cc), "v_rr": torch.ones(cc),
             "v_ri": torch.zeros(cc), "v_ii": torch.ones(cc)}
    move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return move(params), move(state)


def complex_batch_norm(params, state, x: torch.Tensor, *, train: bool, momentum: float = 0.1,
                       eps: float = 1e-5):
    """Complex whitening batch norm: center each complex channel, whiten by
    the inverse square root of its 2x2 covariance (closed form), then the
    learned 2x2 affine and bias. x is [..., 2Cc] [reals || imags]. Returns
    (y, new_state). In a data-parallel step the mean and the covariance are
    the global batch's (``parallel/global_batch.py``)."""
    xr, xi = _split_ri(x)
    axes = tuple(range(x.ndim - 1))
    if train:
        m_r, m_i = gb.mean(xr, dim=axes), gb.mean(xi, dim=axes)
        xr_c, xi_c = xr - m_r, xi - m_i
        v_rr = gb.mean(xr_c * xr_c, dim=axes)
        v_ri = gb.mean(xr_c * xi_c, dim=axes)
        v_ii = gb.mean(xi_c * xi_c, dim=axes)
        new = {"m_r": m_r, "m_i": m_i, "v_rr": v_rr, "v_ri": v_ri, "v_ii": v_ii}
        new_state = {k: state[k] + momentum * (new[k] - state[k]) for k in new}
    else:
        m_r, m_i = state["m_r"], state["m_i"]
        xr_c, xi_c = xr - m_r, xi - m_i
        v_rr, v_ri, v_ii = state["v_rr"], state["v_ri"], state["v_ii"]
        new_state = state
    v_rr, v_ii = v_rr + eps, v_ii + eps

    # inverse square root of the 2x2 covariance, closed form
    tau = v_rr + v_ii
    delta = v_rr * v_ii - v_ri * v_ri
    s = torch.sqrt(delta)
    t = torch.sqrt(tau + 2.0 * s)
    rst = 1.0 / (s * t)
    u_rr, u_ii, u_ri = (s + v_ii) * rst, (s + v_rr) * rst, -v_ri * rst

    # combined affine Z = W @ U
    z_rr = params["w_rr"] * u_rr + params["w_ri"] * u_ri
    z_ri = params["w_rr"] * u_ri + params["w_ri"] * u_ii
    z_ir = params["w_ri"] * u_rr + params["w_ii"] * u_ri
    z_ii = params["w_ri"] * u_ri + params["w_ii"] * u_ii

    yr = z_rr * xr_c + z_ri * xi_c + params["b_r"]
    yi = z_ir * xr_c + z_ii * xi_c + params["b_i"]
    return torch.cat([yr, yi], dim=-1), new_state
