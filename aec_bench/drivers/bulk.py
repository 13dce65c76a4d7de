"""Offline bulk enhancement: batches of whole utterances through
``pipeline/two_stage.two_stage_cancel`` (stage 1, then stage 2), back to back.

The inputs are a pool of distinct batches made on the card at set-up and
cycled; the outputs stay on the card (each pool slot keeps its last ones for
the check). Batches are dispatched ahead of the card and the window ends in a
synchronize, so ``xrt`` is all the audio of the window over all its wall time.

Traffic keys: ``batch``, ``seconds`` (of an utterance), ``pool``,
``quality``, ``check_batches`` (pool slots the check compares, drawn from
the seed), ``scene`` (``scenes.make``'s parameters).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers.common import row_gap, sample, tf32, worst
from aec_bench.trace import span


class Cell:
    def __init__(self, ctx):
        from aec_tpu_torch.configs import KalmanConfig
        from aec_tpu_torch.dsp.stft import StftConfig
        from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
        from aec_tpu_torch.utils.weights import load_npz

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        self.sr = cfg["sample_rate"]
        self.n = int(round(mix["seconds"] * self.sr))
        st = cfg["stft"]
        self.erb = torch.as_tensor(self.ref.dsp.erb_matrix(
            st["win"] // 2 + 1, cfg["erb"]["bands"], cfg["erb"]["max_freq"]).astype(np.float32),
            device=dev)
        kcfg = KalmanConfig(**cfg["kalman"])
        scfg = StftConfig(st["win"], st["hop"], st["fft"], st["window"])
        net = load_npz(str(ctx.path(cfg["weights"])), device=dev)
        g = scenes.generator(ctx.seed, dev)
        self.pool = []
        for _ in range(mix["pool"]):
            s = scenes.make(g, mix["batch"], self.n, mix["scene"], dev)
            self.pool.append((s["far"], s["mic"]))
        self.program = lambda far, mic: two_stage_cancel(  # noqa: E731
            net, far, mic, self.erb, stage1="kalman", lin_cfg=kcfg, scfg=scfg,
            quality=mix["quality"])
        self.outs = {}
        for slot in range(min(2, len(self.pool))):  # the one shape the window runs
            self.run_slot(slot)
        self.outs.clear()

    def run_slot(self, slot: int) -> None:
        out = self.program(*self.pool[slot])
        self.outs[slot] = (out["linear_wav"], out["wav"])

    def window(self, seconds: float, win) -> dict:
        end, n, size = win.start + seconds, 0, len(self.pool)
        while True:
            with span("batch"):
                self.run_slot(n % size)
            n += 1
            if time.perf_counter() >= end:
                break
        with span("drain"):
            if self.ctx.device.type == "cuda":
                torch.cuda.synchronize()
        wall = win.stop()
        batch = self.ctx.mix["batch"]
        return {"attempted": n, "failed": 0,
                "e2e": {"xrt": n * batch * self.n / self.sr / wall},
                "work": {"batches": n, "batch": batch, "samples": self.n, "wall_s": wall}}

    def release(self) -> None:
        self.program = None

    def check(self, control: bool = False) -> dict:
        """The widest gap of the stage-1 output from the reference's Kalman
        on the same far end and mic, and of the wav from the reference's
        LittleNet on that stage-1 output, each row against its mic's peak.
        ``control`` puts the reference in TF32 in the program's place."""
        cfg, ctx = self.ctx.cfg, self.ctx
        hop, win = cfg["stft"]["hop"], cfg["stft"]["win"]
        w = self.ref.load_weights(str(ctx.path(cfg["weights"])), ctx.device)
        gaps = {"linear_gap": 0.0, "wav_gap": 0.0}
        ran = list(range(len(self.pool))) if control else sorted(self.outs)
        slots = [ran[i] for i in sample(ctx.seed, len(ran), ctx.mix["check_batches"], "bulk")]
        with torch.no_grad():
            for slot in slots:
                far, mic = self.pool[slot]
                if control:
                    with tf32(True):
                        lin = self.ref.dsp.kalman_cancel(cfg["kalman"], far, mic, hop)
                        wav = self.ref.littlenet(w, lin, far, self.erb, win, hop)
                else:
                    lin, wav = self.outs[slot]
                scale = mic.abs().amax(-1)
                want_lin = self.ref.dsp.kalman_cancel(cfg["kalman"], far, mic, hop)
                want_wav = self.ref.littlenet(w, lin, far, self.erb, win, hop)
                gaps["linear_gap"] = worst(gaps["linear_gap"], row_gap(lin, want_lin, scale))
                gaps["wav_gap"] = worst(gaps["wav_gap"], row_gap(wav, want_wav, scale))
        return gaps
