"""Plain reference of ``fullsubnet``: FullSubNet at its published widths (Hao
et al., ICASSP 2021, arXiv:2010.15508; ``github.com/haoxiangsnr/FullSubNet``
``recipes/dns_interspeech_2020/fullsubnet/train.toml`` ``[model.args]``),
its training loss and Adam, in plain PyTorch.

Forward, at 16 kHz: magnitudes of the mic and the far end (STFT 512 / 256,
Hann), [B, T, F = 257], 2 zero frames padded at the end (the look-ahead).
The full band: the offline Laplace normalisation ``x / (mean |x| + eps)``
of the mic's magnitudes per utterance, two LSTM layers of 512, a linear to
257 and a ReLU: one embedding value a bin and frame. The sub band, a bin's
row: the 31 bins around it (reflect-padded on frequency) of the mic's and
of the far end's magnitudes and the bin's embedding, 63 values a frame,
normalised together per utterance; in training drop band keeps group g =
0, 1 of samples b = g and bins f = g (mod 2), bin 256 dropped, the groups
stacked (2,048 rows at B = 16); at inference every bin. Two LSTM layers of
384 shared by every row, a linear to 2 and a sigmoid: the masks; the first
2 frames dropped.

Departures from the paper, both the reference AEC repository's
(``scripts/models.py``): the far end's neighbourhood joins the sub band's
input beside the mic's (the paper's sub band sees the noisy mic alone), and
the head is a dual mask (near, echo) through a sigmoid, trained by the
complex-spectrum MSE of the near estimate (the near mask on the mic's
magnitude with the mic's phase) plus the MSE of the echo mask's magnitude
against the echo's, each a mean over the kept (sample, bin) pairs and
frames; the paper's head is a cIRM with the same two outputs a bin.

The recurrences are per-frame loops of torch operations. Nothing of the
program is imported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from aec_bench.reference import dsp
from aec_bench.reference.dccrn import clone, leaves, rebuild  # noqa: F401  (the check's tree tools)


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 products and convolutions on or off inside the block (off is the
    configuration's float32; on, the lower-precision control), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def lstm(p, x):
    """One LSTM layer, zero initial state: [R, T, I] -> [R, T, H]."""
    xp = x @ p["w_ih"].T + p["b_ih"] + p["b_hh"]
    h = x.new_zeros((x.shape[0], p["w_hh"].shape[1]))
    c = torch.zeros_like(h)
    hs = []
    for t in range(x.shape[1]):
        i, f, g, o = (xp[:, t] + h @ p["w_hh"].T).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1)


def norm(x, eps):
    """The offline Laplace normalisation over every axis but the batch."""
    return x / (x.abs().mean(dim=list(range(1, x.ndim)), keepdim=True) + eps)


def unfold(mag, n):
    """[B, T, F] -> [B, T, F, 2n + 1]: each bin's neighbours, reflect-padded."""
    return F.pad(mag, (n, n), mode="reflect").unfold(-1, 2 * n + 1, 1)


def rows_of(b, f, groups, device):
    """(samples, bins) of the sub band's rows: drop band's groups, or every
    (b, f) in order for ``groups`` 1."""
    if groups == 1:
        return (torch.arange(b * f, device=device) // f, torch.arange(b * f, device=device) % f)
    keep = f - f % groups
    samples, bins = [], []
    for g in range(groups):
        for s in range(g, b, groups):
            fs = torch.arange(g, keep, groups, device=device)
            samples.append(torch.full_like(fs, s))
            bins.append(fs)
    return torch.cat(samples), torch.cat(bins)


def features(params, mic_mag, far_mag, net: dict, train: bool):
    """The sub band's input rows [R, T + la, 63] and their (samples, bins)."""
    b, t, f = mic_mag.shape
    la, eps = net["look_ahead"], net["norm_eps"]
    mic_p, far_p = F.pad(mic_mag, (0, 0, 0, la)), F.pad(far_mag, (0, 0, 0, la))
    x = norm(mic_p, eps)
    for p in params["fb_lstm"]:
        x = lstm(p, x)
    emb = torch.relu(x @ params["fb_out"]["w"].T + params["fb_out"]["b"])
    n = net["sb_num_neighbors"]
    sb = norm(torch.cat([unfold(mic_p, n), unfold(far_p, n), emb[..., None]], -1), eps)
    groups = net["num_groups_in_drop_band"] if train and b > 1 else 1
    samples, bins = rows_of(b, f, groups, mic_mag.device)
    return sb[samples, :, bins], samples, bins


def head(params, rows, net: dict):
    """Sub-band rows [R, T + la, 63] -> (mask_near, mask_echo) [R, T]."""
    x = rows
    for p in params["sb_lstm"]:
        x = lstm(p, x)
    m = torch.sigmoid(x @ params["sb_out"]["w"].T + params["sb_out"]["b"])[:, net["look_ahead"]:]
    return m[..., 0], m[..., 1]


def spectra(cfg: dict, mic, far, near, echo):
    """The STFTs the forward and the loss read: mic and far magnitudes, the
    mic's phase, the near end's spectrum, the echo's magnitude, [B, T, F]."""
    win, hop = cfg["stft"]["win"], cfg["stft"]["hop"]
    k = win // 2 + 1
    ms, ns = dsp.stft(mic, win, hop), dsp.stft(near, win, hop)
    return {"mic_mag": dsp.magnitude(ms), "far_mag": dsp.magnitude(dsp.stft(far, win, hop)),
            "phase": torch.atan2(ms[..., k:], ms[..., :k]), "near_re": ns[..., :k],
            "near_im": ns[..., k:], "echo_mag": dsp.magnitude(dsp.stft(echo, win, hop))}


def masks(params, cfg: dict, mic, far, train: bool):
    """mic, far [B, n] -> (mask_near, mask_echo [R, T], samples, bins)."""
    s = spectra(cfg, mic, far, mic, mic)
    rows, samples, bins = features(params, s["mic_mag"], s["far_mag"], cfg["net"], train)
    return (*head(params, rows, cfg["net"]), samples, bins)


def loss_terms(mask_near, mask_echo, s: dict, samples, bins, count: int):
    """The two terms summed over the given rows, each over ``count`` (the
    rows of the whole batch times the frames): a block's share of the loss."""
    def sel(x):
        return x[samples, :, bins]

    mag, ph = sel(s["mic_mag"]), sel(s["phase"])
    est = mask_near * mag
    near = ((est * torch.cos(ph) - sel(s["near_re"])) ** 2).sum() / count
    near = near + ((est * torch.sin(ph) - sel(s["near_im"])) ** 2).sum() / count
    return near + ((mask_echo * mag - sel(s["echo_mag"])) ** 2).sum() / count


def loss(params, cfg: dict, batch, train: bool = True):
    """The training loss of one batch (mic, far, near, echo), whole."""
    s = spectra(cfg, *batch)
    rows, samples, bins = features(params, s["mic_mag"], s["far_mag"], cfg["net"], train)
    m_near, m_echo = head(params, rows, cfg["net"])
    return loss_terms(m_near, m_echo, s, samples, bins, m_near.numel())


def loss_and_grads(params, cfg: dict, batch, block: int = 0, train: bool = True):
    """(loss, {leaf path: gradient}) of one batch, the sub band's rows in
    blocks of ``block`` (0: all at once): each block's forward and backward
    through the sub band alone, its input's gradient summed, then one
    backward through the full band and the features. The same gradient as
    :func:`loss`'s, summed in another order, at a block's memory."""
    named = dict(leaves(params))
    s = spectra(cfg, *batch)
    rows, samples, bins = features(params, s["mic_mag"], s["far_mag"], cfg["net"], train)
    sb_keys = [k for k in named if k.startswith("['sb_")]
    sb = [named[k] for k in sb_keys]
    held = rows.detach()
    d_rows = torch.zeros_like(held)
    sb_grads = [torch.zeros_like(p) for p in sb]
    count = rows.shape[0] * (rows.shape[1] - cfg["net"]["look_ahead"])
    total = 0.0
    step = block or rows.shape[0]
    for a in range(0, rows.shape[0], step):
        x = held[a:a + step].requires_grad_(True)
        m_near, m_echo = head(params, x, cfg["net"])
        part = loss_terms(m_near, m_echo, s, samples[a:a + step], bins[a:a + step], count)
        got = torch.autograd.grad(part, [x, *sb])
        d_rows[a:a + step] = got[0]
        for acc, g in zip(sb_grads, got[1:]):
            acc += g
        total = total + part.detach()
    fb_keys = [k for k in named if k not in sb_keys]
    fb = torch.autograd.grad(rows, [named[k] for k in fb_keys], grad_outputs=d_rows)
    grads = dict(zip(fb_keys, fb)) | dict(zip(sb_keys, sb_grads))
    return total, {k: grads[k] for k in named}


def train(params, state, batches, *, lr: float, cfg: dict, block: int = 0, tf32: bool = False,
          betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam steps of the training loss, one per batch, from copies of
    ``params``, TF32 off (``tf32``: on, the control) -> {"loss": [...],
    "grad": the first step's gradient by leaf path, "params": after the
    last step, "state": {} (no statistics)}."""
    with precision(tf32):
        return _train(params, batches, lr, cfg, block, betas, eps)


def _train(params, batches, lr, cfg, block, betas, eps):
    cur = {k: v.detach().clone() for k, v in leaves(params)}
    m = {k: torch.zeros_like(v) for k, v in cur.items()}
    v2 = {k: torch.zeros_like(v) for k, v in cur.items()}
    losses, first = [], None
    for n, batch in enumerate(batches, start=1):
        leaf = {k: t.requires_grad_(True) for k, t in cur.items()}
        value, g = loss_and_grads(rebuild(params, leaf), cfg, batch, block)
        losses.append(float(value))
        with torch.no_grad():
            if first is None:
                first = g
            nxt = {}
            for k, t in leaf.items():
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g[k]
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * g[k] * g[k]
                m_hat = m[k] / (1 - betas[0] ** n)
                v_hat = v2[k] / (1 - betas[1] ** n)
                nxt[k] = t.detach() - lr * m_hat / (torch.sqrt(v_hat) + eps)
        cur = nxt
    return {"loss": losses, "grad": first, "params": cur, "state": {}}


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, {}) of the configuration's net, drawn from the seed on
    ``device`` in one call, with torch's init (``nn.LSTM``'s and
    ``nn.Linear``'s: U(+-1/sqrt(H)) for every LSTM tensor, U(+-1/sqrt(in))
    for each linear's weight and bias)."""
    net = cfg["net"]
    f, hf, hs = net["num_freqs"], net["fb_model_hidden_size"], net["sb_model_hidden_size"]
    width = 2 * (2 * net["sb_num_neighbors"] + 1) + 1  # mic and far bins, the embedding
    shapes = []
    for ins, h in ((f, hf), (width, hs)):
        for layer in range(net["layers"]):
            i = ins if layer == 0 else h
            shapes += [((4 * h, i), h), ((4 * h, h), h), ((4 * h,), h), ((4 * h,), h)]
        out = f if h == hf else 2
        shapes += [((out, h), h), ((out,), h)]
    sizes = [int(torch.tensor(s).prod()) for s, _ in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    draws = (torch.rand(sum(sizes), generator=g, device=device) * 2 - 1).split(sizes)
    tensors = iter(d.view(s) / b ** 0.5 for d, (s, b) in zip(draws, shapes))

    def band():
        layers = [dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), (next(tensors) for _ in range(4))))
                  for _ in range(net["layers"])]
        return layers, {"w": next(tensors), "b": next(tensors)}

    fb_lstm, fb_out = band()
    sb_lstm, sb_out = band()
    return {"fb_lstm": fb_lstm, "fb_out": fb_out, "sb_lstm": sb_lstm, "sb_out": sb_out}, {}
