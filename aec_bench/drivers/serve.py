"""Live serving: S streams advanced one 16 ms hop a call through
``kernels/serving.serving_step_fused`` (both stages in one kernel), open loop.

A tick falls due every ``tick_ms`` of wall time whether or not the earlier
ones have finished. A tick copies one hop of every stream from pinned host
memory to the card, runs the call, copies the output back to pinned host
memory and ends when it is there; it is timed from its due time, and how late
the generator issued it is recorded. The input is a ring of ticks laid out
tick by tick (each stream a loop of ``ring_ticks`` hops whose echo is wrapped
so the loop has no seam), made on the card from the seed, copied once to
pinned memory and kept under ``ring_bytes``. A loop must be much longer
than the filter (L = 10 blocks): a far end that repeats every P samples has
P / 2 lines in its spectrum, and where they barely outnumber the filter's
2,560 taps the filter is all but unidentifiable and its round-off grows
without bound (21 ticks, 2,688 lines, read gaps up to 0.79 of scale).

Traffic keys: ``streams``, ``tick_ms``, ``ring_ticks``, ``ring_bytes``,
``check_streams`` (streams the check follows, drawn from the seed),
``scene``. The window is ``seconds / tick_ms`` ticks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers.common import percentile, row_gap, sample, tf32, worst
from aec_bench.trace import span

STATE_LEAVES = ("wr", "wi", "p", "psi", "h", "tail")


class Cell:
    def __init__(self, ctx):
        from aec_tpu_torch.configs import KalmanConfig
        from aec_tpu_torch.dsp.stft import StftConfig
        from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused
        from aec_tpu_torch.utils.weights import load_npz

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        st = cfg["stft"]
        self.hop = st["hop"]
        self.streams = s = int(ctx.extra.get("streams", mix["streams"]))
        ring = min(mix["ring_ticks"], mix["ring_bytes"] // (2 * 4 * s * self.hop))
        if ring < 1:
            raise ValueError(f"{s} streams do not fit one tick in {mix['ring_bytes']} B")
        self.ring = ring
        self.erb = torch.as_tensor(self.ref.dsp.erb_matrix(
            st["win"] // 2 + 1, cfg["erb"]["bands"], cfg["erb"]["max_freq"]).astype(np.float32),
            device=dev)
        kcfg = KalmanConfig(**cfg["kalman"])
        scfg = StftConfig(st["win"], st["hop"], st["fft"], st["window"])
        net = load_npz(str(ctx.path(cfg["weights"])), device=dev)
        pin = dev.type == "cuda"
        self.far_ring = torch.empty(ring, s, self.hop, pin_memory=pin)
        self.mic_ring = torch.empty(ring, s, self.hop, pin_memory=pin)
        self.watch = sample(ctx.seed, s, mix["check_streams"], "serve")
        g = scenes.generator(ctx.seed, dev)
        chunk, n = 8192, ring * self.hop
        watched = []
        for lo in range(0, s, chunk):
            rows = min(chunk, s - lo)
            sc = scenes.make(g, rows, n, mix["scene"], dev, circular=True)
            for key, dst in (("far", self.far_ring), ("mic", self.mic_ring)):
                dst[:, lo:lo + rows].copy_(sc[key].reshape(rows, ring, self.hop).transpose(0, 1))
            idx = [w - lo for w in self.watch if lo <= w < lo + rows]
            if idx:
                watched.append((sc["far"][idx].clone(), sc["mic"][idx].clone()))
        self.watch_far = torch.cat([f for f, _ in watched])  # (watched, ring * hop)
        self.watch_mic = torch.cat([m for _, m in watched])
        self.far_d = torch.empty(s, self.hop, device=dev)
        self.mic_d = torch.empty(s, self.hop, device=dev)
        self.out_h = torch.empty(s, self.hop, pin_memory=pin)
        self.watch_idx = torch.tensor(self.watch)
        self.init = lambda: serving_init(s, kcfg=kcfg, scfg=scfg,  # noqa: E731
                                         e_bands=cfg["erb"]["bands"], device=dev)
        self.program = lambda state: serving_step_fused(  # noqa: E731
            net, state, self.far_d, self.mic_d, self.erb, kcfg, scfg, stage1="kalman")
        self.done = torch.cuda.Event() if pin else None
        self.state = self.init()
        for i in range(ring):  # the one shape the window runs, every ring slot
            self.tick(i)
        self.state = self.init()

    def tick(self, i: int) -> None:
        r = i % self.ring
        with span("copy_in"):
            self.far_d.copy_(self.far_ring[r], non_blocking=True)
            self.mic_d.copy_(self.mic_ring[r], non_blocking=True)
        with span("call"):
            self.state, out = self.program(self.state)
        with span("copy_out"):
            self.out_h.copy_(out, non_blocking=True)
        with span("wait"):
            if self.done is not None:
                self.done.record()
                self.done.synchronize()

    def window(self, seconds: float, win) -> dict:
        period = self.ctx.mix["tick_ms"] / 1e3
        ticks = int(round(seconds / period))
        lat, late = [], []
        self.kept = torch.empty(ticks, len(self.watch), self.hop)
        start = win.start
        for i in range(ticks):
            due = start + i * period
            # a spin, not a sleep: a sleep's wake-up in a shared host runs
            # late by up to ~10 ms, and that lateness would be the tail
            issued = time.perf_counter()
            while issued < due:
                issued = time.perf_counter()
            self.tick(i)
            lat.append(time.perf_counter() - due)
            late.append(issued - due)
            torch.index_select(self.out_h, 0, self.watch_idx, out=self.kept[i])
        wall = win.stop()
        self.ticks = ticks
        return {"attempted": ticks, "failed": 0,
                "e2e": {"hop_p95_ms": 1e3 * percentile(lat, 95)},
                "work": {"ticks": ticks, "streams": self.streams, "wall_s": wall},
                "host": {"late_s": late, "latency_s": lat}}

    def release(self) -> None:
        self.program = None
        self.state = {k: v[self.watch_idx.to(v.device)] for k, v in self.state.items()}

    def check(self, control: bool = False) -> dict:
        """The widest gap of the followed streams' outputs, every tick, from
        the reference's streaming hop (each stream against its mic's peak),
        and of their state after the window (each leaf against its own
        peak). ``control`` puts the reference in TF32 in the program's place."""
        cfg, ctx = self.ctx.cfg, self.ctx
        w = self.ref.load_weights(str(ctx.path(cfg["weights"])), ctx.device)
        scale = self.watch_mic.abs().amax(-1)
        n = len(self.watch)

        def follow(precise: bool):
            with tf32(not precise), torch.no_grad():
                s = self.ref.Stream(cfg, w, self.erb, n, ctx.device)
                outs = torch.empty(self.ticks, n, self.hop)
                for i in range(self.ticks):
                    r = i % self.ring
                    blk = slice(r * self.hop, (r + 1) * self.hop)
                    outs[i] = s.step(self.watch_far[:, blk], self.watch_mic[:, blk]).cpu()
                return outs, s.state()

        want, want_state = follow(True)
        if control:
            got, got_state = follow(False)
        else:
            got = self.kept
            nm = self.state["nm"]
            got_state = dict({k: self.state[k] for k in STATE_LEAVES},
                             mon_mic=nm[:, 5], mon_lin=nm[:, 6])
        gaps = {"out_gap": row_gap(got.transpose(0, 1).flatten(1), want.transpose(0, 1).flatten(1),
                                   scale.cpu())}
        state_gap = 0.0
        for k, v in want_state.items():
            ref_scale = torch.clamp_min(v.abs().amax(), 1e-12)
            d = (got_state[k].to(v.device).float() - v).abs().amax()
            state_gap = worst(state_gap, float(d / ref_scale))
        gaps["state_gap"] = state_gap
        return gaps
