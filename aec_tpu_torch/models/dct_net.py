"""DCT-domain experimental nets (``aec_tpu/models/dct_net.py``).

The reference's two DCT experiments, as the JAX package realizes them:

- :func:`dct_matrix`: the DCT-II basis the reference builds
  (networks.py:301-306), a host precompute;
- :func:`dct_features`: enframe -> hann window -> DCT;
- ``dnn_*``: the DCT MLP: clamp to [-1, 1], keep the first ``keep``
  coefficients, Linear+PReLU x2 -> Linear+Tanh, zero-pad, inverse DCT, raw
  overlap-add (no envelope normalization);
- ``cnn_*``: a conv encoder over DCT frames, a GRU bottleneck and a
  transposed-conv decoder with skips, emitting a DCT-domain mask.

The functions keep the JAX package's names and signatures on dicts of
tensors (layouts as JAX's, conv kernels HWIO), so a JAX tree carries over
leaf for leaf; :class:`DctDnn` and :class:`DctCnn` hold the same trees as
modules. No kernel of their own: the CNN's GRU routes as ``ops.gru.gru_scan``
does. Its H = 512 is past K8's register path, so a CUDA tensor at T >= 64
takes K8's wide path forward and K8b's backward at every batch the wide
plan holds (to 36 rows: the training batch of 16 and batch-1 validation).
JAX routes its kernel at batch 1 only (``aec_tpu/ops/gru.py:108``), where
its other route is a compiled ``lax.scan``; the port's is an eager loop of
~6 launches a frame, so it routes wider.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from aec_tpu_torch.dsp.stft import frame_signal, overlap_add
from aec_tpu_torch.dsp.windows import periodic_window
from aec_tpu_torch.models.tree_net import TreeNet
from aec_tpu_torch.ops import complex_layers as cl
from aec_tpu_torch.ops.gru import gru_init, gru_scan
from aec_tpu_torch.parallel import global_batch as gb


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(n: int) -> np.ndarray:
    """DCT-II basis (win, win): M[t, k] = sqrt(2/N) cos((t+1/2) pi k / N),
    first column scaled by sqrt(1/2) (networks.py:301-306)."""
    k = np.arange(n)[None, :]
    t = (np.arange(n)[:, None] + 0.5) * np.pi / n
    m = np.sqrt(2.0 / n) * np.cos(t @ k)
    m[:, 0] *= np.sqrt(0.5)
    return m


def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_dct_matrix_np(n), dtype=dtype, device=device)


def dct_features(x: torch.Tensor, win: int = 512, hop: int = 256) -> torch.Tensor:
    """[B, n] -> [B, T, win] windowed DCT frames (no padding, like unfold)."""
    frames = frame_signal(x, win, hop)
    w = torch.as_tensor(periodic_window("hann", win), dtype=x.dtype, device=x.device)
    return (frames * w) @ dct_matrix(win, x.dtype, x.device)


def raw_overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Filpframe_OverlapA semantics (networks.py:59-74): plain OLA sum."""
    return overlap_add(frames, hop)


def _idct_wav(coeffs: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """Kept coefficients [B, T, keep] -> zero-padded to ``win``, inverse DCT,
    raw overlap-add -> [B, (T-1)*hop + win]."""
    padded = torch.nn.functional.pad(coeffs, (0, win - coeffs.shape[-1]))
    return raw_overlap_add(padded @ dct_matrix(win, coeffs.dtype, coeffs.device).T, hop)


@dataclasses.dataclass(frozen=True)
class DctDnnConfig:
    win: int = 512
    hop: int = 256
    keep: int = 100  # DCT coefficients kept (networks.py:334-336)
    hidden: int = 100


def dnn_init(cfg: DctDnnConfig = DctDnnConfig(), *, generator: torch.Generator | None = None,
             device="cuda") -> dict:
    """U(-1/sqrt(in), 1/sqrt(in)) weights and biases, PReLU slopes 0.25;
    drawn on the CPU from ``generator`` (JAX draws its own numbers from its
    key), then moved to ``device``."""

    def linear(i, o):
        bound = 1.0 / math.sqrt(i)
        w = torch.empty(o, i).uniform_(-bound, bound, generator=generator)
        b = torch.empty(o).uniform_(-bound, bound, generator=generator)
        return {"w": w.to(device), "b": b.to(device)}

    return {"lin1": linear(cfg.keep, cfg.hidden), "lin2": linear(cfg.hidden, cfg.hidden),
            "lin3": linear(cfg.hidden, cfg.keep), "prelu1": cl.prelu_init(device=device),
            "prelu2": cl.prelu_init(device=device)}


def dnn_apply(params, noisy: torch.Tensor, cfg: DctDnnConfig = DctDnnConfig()) -> dict:
    """[B, n] -> ``out_dct`` [B, T, keep], ``wav`` [B, (T-1)*hop + win]."""
    d = torch.clamp(dct_features(noisy, cfg.win, cfg.hop), -1.0, 1.0)[..., : cfg.keep]
    h = cl.prelu(params["prelu1"], d @ params["lin1"]["w"].T + params["lin1"]["b"])
    h = cl.prelu(params["prelu2"], h @ params["lin2"]["w"].T + params["lin2"]["b"])
    out_dct = torch.tanh(h @ params["lin3"]["w"].T + params["lin3"]["b"])
    return {"out_dct": out_dct, "wav": _idct_wav(out_dct, cfg.win, cfg.hop)}


def dnn_loss(params, noisy, clean, cfg: DctDnnConfig = DctDnnConfig()):
    """MSE between estimated and clean clamped/truncated DCT frames (in a
    data-parallel step, this rank's share of the global batch's)."""
    out = dnn_apply(params, noisy, cfg)
    clean_dct = torch.clamp(dct_features(clean, cfg.win, cfg.hop), -1.0, 1.0)[..., : cfg.keep]
    return gb.mean_share((out["out_dct"] - clean_dct) ** 2), out


@dataclasses.dataclass(frozen=True)
class DctCnnConfig:
    win: int = 512
    hop: int = 256
    keep: int = 128
    channels: tuple[int, ...] = (1, 8, 16, 32)
    gru_hidden: int = 128


def cnn_init(cfg: DctCnnConfig = DctCnnConfig(), *, generator: torch.Generator | None = None,
             device="cuda") -> dict:
    """N(0, 0.05) (1, 3) conv kernels with zero biases, PReLU slopes 0.25, a
    uniform-init GRU over the deepest level's (frequency x channel)
    features; drawn on the CPU from ``generator``, then moved."""
    chans = cfg.channels
    n = len(chans) - 1
    feat = chans[-1] * (cfg.keep // 2 ** n)

    def conv(ci, co):
        w = 0.05 * torch.randn((1, 3, ci, co), generator=generator)
        return {"w": w.to(device), "b": torch.zeros(co, device=device)}

    enc = [{"conv": conv(chans[i], chans[i + 1]), "prelu": cl.prelu_init(device=device)}
           for i in range(n)]
    dec = [{"conv": conv(2 * chans[n - i], chans[n - i - 1] if i < n - 1 else 1),
            "prelu": cl.prelu_init(device=device)} for i in range(n)]
    gru = gru_init(feat, feat, orthogonal=False, generator=generator, device=device)
    return {"encoder": enc, "decoder": dec, "gru": gru}


def cnn_apply(params, noisy: torch.Tensor, cfg: DctCnnConfig = DctCnnConfig()) -> dict:
    """[B, n] -> a DCT-domain masking denoiser: ``est_dct`` and ``mask``
    [B, T, keep], ``wav``. Activations NHWC with (T, F) spatial."""
    d = dct_features(noisy, cfg.win, cfg.hop)[..., : cfg.keep]  # [B, T, F]
    x = d[..., None]
    skips = []
    for layer in params["encoder"]:
        x = cl.prelu(layer["prelu"], cl.conv(layer["conv"], x, (1, 2), [(0, 0), (1, 1)]))
        skips.append(x)

    b, t, f_b, c = x.shape
    seq, _ = gru_scan(params["gru"], x.reshape(b, t, f_b * c))
    x = seq.reshape(b, t, f_b, c)

    n_dec = len(params["decoder"])
    for i, layer in enumerate(params["decoder"]):
        x = torch.cat([x, skips[-1 - i]], dim=-1)
        x = cl.conv_transpose(layer["conv"], x, (1, 2), (0, 1), (0, 1))
        x = torch.tanh(x) if i == n_dec - 1 else cl.prelu(layer["prelu"], x)

    mask = x[..., 0][:, :, : cfg.keep]  # [B, T, keep]
    est_dct = mask * d
    return {"est_dct": est_dct, "mask": mask, "wav": _idct_wav(est_dct, cfg.win, cfg.hop)}


def cnn_loss(params, noisy, clean, cfg: DctCnnConfig = DctCnnConfig()):
    out = cnn_apply(params, noisy, cfg)
    clean_dct = dct_features(clean, cfg.win, cfg.hop)[..., : cfg.keep]
    return gb.mean_share((out["est_dct"] - clean_dct) ** 2), out


class DctDnn(TreeNet):
    """The DCT MLP holding ``dnn_init``'s tree; ``forward(noisy)`` is ``dnn_apply``."""

    def __init__(self, params: dict, cfg: DctDnnConfig = DctDnnConfig()):
        super().__init__(params, {}, cfg)

    def forward(self, noisy: torch.Tensor) -> dict:
        return dnn_apply(self.params(), noisy, self.cfg)


class DctCnn(TreeNet):
    """The DCT U-Net holding ``cnn_init``'s tree; ``forward(noisy)`` is ``cnn_apply``."""

    def __init__(self, params: dict, cfg: DctCnnConfig = DctCnnConfig()):
        super().__init__(params, {}, cfg)

    def forward(self, noisy: torch.Tensor) -> dict:
        return cnn_apply(self.params(), noisy, self.cfg)
