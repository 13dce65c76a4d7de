"""Plain reference of ``littlenet_kalman``: Kalman stage 1, then LittleNet.

LittleNet (SZU-Speech ``Stage2_lhm/scripts/network/ERB.py:203-335``): STFT
magnitudes of the stage-1 output and of the far end (in-sqrt 1e-9), ERB
projections, features ``[mic_erb || |mic_erb - far_erb|]``, a GRU (torch's
gate order r, z, n with ``b_hn`` inside the reset product), ``[h || mic_erb]``
through Linear + ReLU and Linear + Sigmoid to the band mask, the masked bands
back-projected by ``erb.T`` into one real gain per bin on both parts of the
spectrum, iSTFT plus 1e-9. No pseudo-norm (``normalize=False``, the
benchmark's route) and no gain normalisation.

The weights are read from the configuration's ``.npz`` file by the keys the
file carries; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from aec_bench.reference import dsp

def load_weights(path: str, device) -> dict[str, torch.Tensor]:
    """The npz's leaves as float32 tensors: ``gru.{w_ih,w_hh,b_ih,b_hh}``,
    ``lin1.{w,b}``, ``lin2.{w,b}``."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            parts = [p.strip("'") for p in key.replace("]", "").split("[") if p]
            out[".".join(parts[1:])] = torch.as_tensor(z[key], dtype=torch.float32, device=device)
    return out


def gru_step(w: dict, h: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    hp = h @ w["gru.w_hh"].T + w["gru.b_hh"]
    xr, xz, xn = xp.chunk(3, -1)
    hr, hz, hn = hp.chunk(3, -1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def head(w: dict, h: torch.Tensor, mic_erb: torch.Tensor) -> torch.Tensor:
    hid = torch.relu(torch.cat([h, mic_erb], -1) @ w["lin1.w"].T + w["lin1.b"])
    return torch.sigmoid(hid @ w["lin2.w"].T + w["lin2.b"])


def littlenet(w: dict, lin: torch.Tensor, far: torch.Tensor, erb: torch.Tensor,
              win: int, hop: int) -> torch.Tensor:
    """Offline stage 2: [B, n] stage-1 output and far end -> wav [B, n]."""
    mic_spec = dsp.stft(lin, win, hop)
    mic_erb = dsp.magnitude(mic_spec) @ erb
    far_erb = dsp.magnitude(dsp.stft(far, win, hop)) @ erb
    xp = torch.cat([mic_erb, torch.abs(mic_erb - far_erb)], -1) @ w["gru.w_ih"].T + w["gru.b_ih"]
    h = xp.new_zeros((xp.shape[0], w["gru.w_hh"].shape[1]))
    hs = []
    for t in range(xp.shape[1]):
        h = gru_step(w, h, xp[:, t])
        hs.append(h)
    mask = head(w, torch.stack(hs, 1), mic_erb)
    gain = (mask * mic_erb) @ erb.T
    k = gain.shape[-1]
    out = torch.cat([gain * mic_spec[..., :k], gain * mic_spec[..., k:]], -1)
    return dsp.istft(out, win, hop) + 1e-9


class Stream:
    """S streams hop by hop: Kalman on the new block, then one LittleNet
    frame over ``[previous block || this block]``; the emitted block is the
    previous frame's second half plus this frame's first half, divided by
    the squared window's periodic overlap-add plus 1e-8, plus 1e-9 (one hop
    behind). ``mon`` holds the 0.99 moving averages of each hop's mic and
    stage-1 output power."""

    def __init__(self, cfg: dict, w: dict, erb: torch.Tensor, streams: int, device):
        self.w, self.erb = w, erb
        self.hop, self.win = cfg["stft"]["hop"], cfg["stft"]["win"]
        self.kal = dsp.Kalman(cfg["kalman"], (streams,), self.hop, device)
        z = lambda *s: torch.zeros(streams, *s, device=device)  # noqa: E731
        self.prev_far, self.prev_lin, self.tail = z(self.hop), z(self.hop), z(self.hop)
        self.h = z(w["gru.w_hh"].shape[1])
        self.mon = z(2)
        w2 = dsp.hann(self.win) ** 2
        self.env = torch.as_tensor(w2[:self.hop] + w2[self.hop:], dtype=torch.float32,
                                   device=device) + 1e-8

    def step(self, far: torch.Tensor, mic: torch.Tensor) -> torch.Tensor:
        far_frame = torch.cat([self.prev_far, far], -1)
        lin = self.kal.step(far_frame, mic)
        win = torch.as_tensor(dsp.hann(self.win), dtype=torch.float32, device=far.device)
        spec = torch.fft.rfft(torch.cat([self.prev_lin, lin], -1) * win, dim=-1)
        spec = torch.cat([spec.real, spec.imag], -1)
        mic_erb = dsp.magnitude(spec) @ self.erb
        far_spec = torch.fft.rfft(far_frame * win, dim=-1)
        far_erb = dsp.magnitude(torch.cat([far_spec.real, far_spec.imag], -1)) @ self.erb
        xp = torch.cat([mic_erb, torch.abs(mic_erb - far_erb)], -1) @ self.w["gru.w_ih"].T
        self.h = gru_step(self.w, self.h, xp + self.w["gru.b_ih"])
        gain = (head(self.w, self.h, mic_erb) * mic_erb) @ self.erb.T
        k = gain.shape[-1]
        syn = dsp.synth_frames(torch.cat([gain * spec[..., :k], gain * spec[..., k:]], -1),
                               self.win)
        out = (self.tail + syn[:, :self.hop]) / self.env + 1e-9
        self.tail = syn[:, self.hop:]
        self.prev_far, self.prev_lin = far, lin
        power = torch.stack([torch.mean(mic * mic, -1), torch.mean(lin * lin, -1)], -1)
        self.mon = 0.99 * self.mon + 0.01 * power
        return out

    def state(self) -> dict[str, torch.Tensor]:
        """The leaves a serving state carries, in its layout: W's parts and
        P as (S, L, K), psi (S, K), h (S, E), the synthesis tail and the
        two monitor averages."""
        wr, wi = self.kal.complex_w()
        return {"wr": wr, "wi": wi, "p": self.kal.p,
                "psi": self.kal.psi, "h": self.h, "tail": self.tail,
                "mon_mic": self.mon[:, 0], "mon_lin": self.mon[:, 1]}
