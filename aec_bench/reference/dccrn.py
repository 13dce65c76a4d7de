"""Plain reference of ``dccrn``: DCCRN v2 (SZU-Speech ``scripts/network/dccrn.py:103-594``
at ``scripts/configs.py:29-46``), its v1 training loss and Adam, in plain PyTorch.

Forward: STFT of mic and far end, the DC bin dropped, channels
``[mic_re, far_re || mic_im, far_im]`` on a (frequency, time) grid; six
complex convolutions (kernel (5, 1), stride (2, 1), frequency padding 2),
each followed by the whitening complex BatchNorm and a PReLU; two complex
LSTMs over the channel-major bottleneck features (each the cross-combination
of a "real" and an "imag" LSTM applied to both parts: ``(r2r - i2i, i2r +
r2i)``); five transposed complex convolutions with complex skip
concatenation, BatchNorm and PReLU, and a bare transposed convolution as the
v2 head; masking 'E' (``tanh`` of the mask's magnitude times the mic's, the
phases added); iSTFT.

The parameters come as nested dicts and lists of tensors in the layout the
benchmark makes them in (conv kernels HWIO per part, LSTM rows [i, f, g, o]).
Nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aec_bench.reference import dsp


def complex_conv(p, x, transpose: bool):
    """x [B, F, T, 2C] ([re || im] channels) through the complex conv of
    kernels ``w_r``, ``w_i`` (kh, kw, Cin/2, Cout/2) and biases."""
    c = x.shape[-1] // 2
    xr, xi = x[..., :c].permute(0, 3, 1, 2), x[..., c:].permute(0, 3, 1, 2)
    if transpose:
        conv = lambda v, w: F.conv_transpose2d(  # noqa: E731
            v, w.permute(2, 3, 0, 1), stride=(2, 1), padding=(2, 0), output_padding=(1, 0))
    else:
        conv = lambda v, w: F.conv2d(  # noqa: E731
            F.pad(v, (0, 0, 2, 2)), w.permute(3, 2, 0, 1), stride=(2, 1))
    yr = conv(xr, p["w_r"]) - conv(xi, p["w_i"]) + p["b_r"][:, None, None]
    yi = conv(xr, p["w_i"]) + conv(xi, p["w_r"]) + p["b_i"][:, None, None]
    return torch.cat([yr, yi], 1).permute(0, 2, 3, 1)


def complex_bn(p, s, x, train: bool):
    """Whitening complex BatchNorm; the running statistics move by 0.1 of
    the batch's (biased) statistics in training."""
    c = x.shape[-1] // 2
    xr, xi = x[..., :c], x[..., c:]
    axes = (0, 1, 2)
    if train:
        m_r, m_i = xr.mean(axes), xi.mean(axes)
        xr, xi = xr - m_r, xi - m_i
        v_rr, v_ri, v_ii = (xr * xr).mean(axes), (xr * xi).mean(axes), (xi * xi).mean(axes)
        batch = {"m_r": m_r, "m_i": m_i, "v_rr": v_rr, "v_ri": v_ri, "v_ii": v_ii}
        new = {k: s[k] + 0.1 * (batch[k].detach() - s[k]) for k in batch}
    else:
        xr, xi = xr - s["m_r"], xi - s["m_i"]
        v_rr, v_ri, v_ii, new = s["v_rr"], s["v_ri"], s["v_ii"], s
    v_rr, v_ii = v_rr + 1e-5, v_ii + 1e-5
    sq = torch.sqrt(v_rr * v_ii - v_ri * v_ri)
    inv = 1.0 / (sq * torch.sqrt(v_rr + v_ii + 2.0 * sq))
    u_rr, u_ii, u_ri = (sq + v_ii) * inv, (sq + v_rr) * inv, -v_ri * inv
    w_rr, w_ri, w_ii = p["w_rr"], p["w_ri"], p["w_ii"]
    yr = (w_rr * u_rr + w_ri * u_ri) * xr + (w_rr * u_ri + w_ri * u_ii) * xi + p["b_r"]
    yi = (w_ri * u_rr + w_ii * u_ri) * xr + (w_ri * u_ri + w_ii * u_ii) * xi + p["b_i"]
    return torch.cat([yr, yi], -1), new


def prelu(a, x):
    return torch.where(x >= 0, x, a * x)


def lstm(p, x):
    """One LSTM, zero initial state: [B, T, I] -> [B, T, H]."""
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


def complex_lstm(p, r, i):
    """Both LSTMs over both parts, in one loop: the pair of inputs as rows."""
    b = r.shape[0]
    both = torch.cat([r, i], 0)
    yr, yi = lstm(p["real"], both), lstm(p["imag"], both)
    return yr[:b] - yi[b:], yr[b:] + yi[:b]


def grid(spec):
    k = spec.shape[-1] // 2
    return spec[..., :k].transpose(-1, -2), spec[..., k:].transpose(-1, -2)


def forward(params, state, mic, far, *, train: bool, win: int = 512, hop: int = 256):
    """mic, far [B, n] -> (wav, mask_re, mask_im, mic grids, new state)."""
    mic_re, mic_im = grid(dsp.stft(mic, win, hop))
    far_re, far_im = grid(dsp.stft(far, win, hop))
    x = torch.stack([mic_re, far_re, mic_im, far_im], -1)[:, 1:]
    skips, new_enc = [], []
    for lp, ls in zip(params["encoder"], state["encoder"]):
        x, s = complex_bn(lp["bn"], ls["bn"], complex_conv(lp["conv"], x, False), train)
        x = prelu(lp["prelu"], x)
        new_enc.append({"bn": s})
        skips.append(x)
    b, f, t, c = x.shape
    r = x[..., :c // 2].permute(0, 2, 3, 1).reshape(b, t, -1)
    i = x[..., c // 2:].permute(0, 2, 3, 1).reshape(b, t, -1)
    for lp in params["rnn"]:
        r, i = complex_lstm(lp, r, i)
    x = torch.cat([r.reshape(b, t, c // 2, f).permute(0, 3, 1, 2),
                   i.reshape(b, t, c // 2, f).permute(0, 3, 1, 2)], -1)
    new_dec = []
    n_dec = len(params["decoder"])
    for j, (lp, ls) in enumerate(zip(params["decoder"], state["decoder"])):
        skip = skips[-1 - j]
        h, hs = x.shape[-1] // 2, skip.shape[-1] // 2
        x = torch.cat([x[..., :h], skip[..., :hs], x[..., h:], skip[..., hs:]], -1)
        x = complex_conv(lp["conv"], x, True)
        if j == n_dec - 1:  # the v2 head: a bare transposed conv
            new_dec.append({"bn": ls["bn"]})
            break
        x, s = complex_bn(lp["bn"], ls["bn"], x, train)
        x = prelu(lp["prelu"], x)
        new_dec.append({"bn": s})
    mask_re = F.pad(x[..., 0], (0, 0, 1, 0))
    mask_im = F.pad(x[..., 1], (0, 0, 1, 0))
    mag = torch.sqrt(mask_re ** 2 + mask_im ** 2)
    phase = torch.atan2(mask_im / (mag + 1e-8), mask_re / (mag + 1e-8))
    est_mag = torch.tanh(mag) * torch.sqrt(mic_re ** 2 + mic_im ** 2 + 1e-8)
    est_phase = torch.atan2(mic_im, mic_re) + phase
    spec = torch.cat([(est_mag * torch.cos(est_phase)).transpose(-1, -2),
                      (est_mag * torch.sin(est_phase)).transpose(-1, -2)], -1)
    wav = dsp.istft(spec, win, hop)
    return wav, mask_re, mask_im, (mic_re, mic_im), {"encoder": new_enc, "decoder": new_dec}


def loss_v1(params, state, mic, far, near, echo):
    """0.3 MSE(mask, cIRM) + 0.7 MSE(echo through the mask, 0) -> (loss, new state)."""
    _, m_re, m_im, (mr, mi), new = forward(params, state, mic, far, train=True)
    nr, ni = grid(dsp.stft(near))
    er, ei = grid(dsp.stft(echo))
    den = mr ** 2 + mi ** 2 + 1e-9
    c_r, c_i = (mr * nr + mi * ni) / den, (mr * ni - mi * nr) / den
    l_mask = torch.mean((m_re - c_r) ** 2) + torch.mean((m_im - c_i) ** 2)
    l_echo = torch.mean((er * m_re - ei * m_im) ** 2) + torch.mean((er * m_im + ei * m_re) ** 2)
    return 0.3 * l_mask + 0.7 * l_echo, new


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for j, v in enumerate(tree):
            yield from leaves(v, f"{prefix}[{j}]")
    else:
        yield prefix, tree


def rebuild(tree, values: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values, f"{prefix}[{j}]") for j, v in enumerate(tree)]
    return values[prefix]


def train(params, state, batches, *, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam steps of the v1 loss, one per batch (mic, far, near, echo), from
    copies of ``params`` and ``state`` -> {"loss": [...], "grad": the first
    step's gradient by leaf path, "params": after the last step, "state":
    the BatchNorm statistics after the last step}."""
    cur = {k: v.detach().clone() for k, v in leaves(params)}
    st = rebuild(state, {k: v.detach().clone() for k, v in leaves(state)})
    m = {k: torch.zeros_like(v) for k, v in cur.items()}
    v2 = {k: torch.zeros_like(v) for k, v in cur.items()}
    losses, first = [], None
    for n, batch in enumerate(batches, start=1):
        leaf = {k: t.requires_grad_(True) for k, t in cur.items()}
        loss, st = loss_v1(rebuild(params, leaf), st, *batch)
        grads = torch.autograd.grad(loss, list(leaf.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: torch.zeros_like(t) if d is None else d for (k, t), d in
                 zip(leaf.items(), grads)}
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
        st = rebuild(st, {k: v.detach() for k, v in leaves(st)})
    return {"loss": losses, "grad": first, "params": cur, "state": dict(leaves(st))}


def enhance(params, state, kalman_cfg: dict, far, mic, block: int = 256):
    """Inference as the Tester runs it: Kalman stage 1, then the forward in
    eval mode -> wav [B, n]."""
    with torch.no_grad():
        lin = dsp.kalman_cancel(kalman_cfg, far, mic, block)
        return forward(params, state, lin, far, train=False)[0]


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, BatchNorm state) of the configuration's net, drawn from the
    seed on ``device`` in three large calls, with the source's init: conv
    kernels N(0, 0.05), zero conv biases, the complex BatchNorms' W_rr = W_ii
    = 1 and W_ri ~ U(-0.9, 0.9), PReLU slopes 0.25, LSTM tensors U(+-1/sqrt(H)),
    running means 0 and covariances I."""
    net = cfg["net"]
    chans, kh, kw = net["conv_channels"], net["kernel"][0], net["kernel"][1]
    n_enc = len(chans) - 1
    convs = [(chans[i], chans[i + 1]) for i in range(n_enc)]
    convs += [(2 * chans[i + 1], chans[i] if i > 0 else 2) for i in range(n_enc - 1, -1, -1)]
    bns = ([chans[i + 1] // 2 for i in range(n_enc)]
           + [chans[i] // 2 for i in range(n_enc - 1, 0, -1)])
    bottom = (cfg["stft"]["win"] // 2) // net["stride"][0] ** n_enc
    h = chans[-1] // 2 * bottom  # per part, I = H
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    conv_sizes = [2 * kh * kw * (ci // 2) * (co // 2) for ci, co in convs]
    conv_all = iter((0.05 * torch.randn(sum(conv_sizes), generator=g, device=device))
                    .split(conv_sizes))
    w_ri = iter((torch.rand(sum(bns), generator=g, device=device) * 1.8 - 0.9).split(bns))
    lstm_sizes = [4 * h * h, 4 * h * h, 4 * h, 4 * h] * 2 * net["rnn_layers"]
    bound = 1.0 / h ** 0.5
    lstm_all = iter(((torch.rand(sum(lstm_sizes), generator=g, device=device) * 2 - 1) * bound)
                    .split(lstm_sizes))

    def conv(ci, co):
        w = next(conv_all).view(2, kh, kw, ci // 2, co // 2)
        z = torch.zeros(co // 2, device=device)
        return {"w_r": w[0].contiguous(), "w_i": w[1].contiguous(), "b_r": z, "b_i": z.clone()}

    def bn(c):
        one = torch.ones(c, device=device)
        p = {"w_rr": one, "w_ri": next(w_ri).contiguous(), "w_ii": one.clone(),
             "b_r": torch.zeros(c, device=device), "b_i": torch.zeros(c, device=device)}
        s = {"m_r": torch.zeros(c, device=device), "m_i": torch.zeros(c, device=device),
             "v_rr": one.clone(), "v_ri": torch.zeros(c, device=device), "v_ii": one.clone()}
        return p, s

    def prelu():
        return torch.tensor(0.25, device=device)

    enc, enc_s, dec, dec_s = [], [], [], []
    for j, (ci, co) in enumerate(convs):
        layer = {"conv": conv(ci, co)}
        if j < n_enc or j < len(convs) - 1:
            layer["bn"], s = bn(co // 2)
            layer["prelu"] = prelu()
        else:
            s = {}
        (enc if j < n_enc else dec).append(layer)
        (enc_s if j < n_enc else dec_s).append({"bn": s})

    def lstm_p():
        w_ih, w_hh, b_ih, b_hh = (next(lstm_all).contiguous() for _ in range(4))
        return {"w_ih": w_ih.view(4 * h, h), "w_hh": w_hh.view(4 * h, h), "b_ih": b_ih,
                "b_hh": b_hh}

    rnn = [{"real": lstm_p(), "imag": lstm_p()} for _ in range(net["rnn_layers"])]
    return {"encoder": enc, "decoder": dec, "rnn": rnn}, {"encoder": enc_s, "decoder": dec_s}


def clone(tree):
    """A deep copy of a weight tree."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.detach().clone()
