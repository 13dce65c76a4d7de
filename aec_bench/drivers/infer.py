"""One utterance at a time, as the reference's Tester and ``cli/infer`` run it:
``cli/infer._make_enhancer`` (stage 1 on the utterance as a batch of one,
then the net in eval mode), closed loop with one client.

Each utterance is copied in from a pinned host pool, enhanced, and its wav
copied back to pinned host memory; the next one starts when it is there.
Each is timed from its issue to its wav on the host. The weights are made
from the seed and written once, at set-up, as the checkpoint the factory
reads (under ``TMPDIR``, removed after the run).

Traffic keys: ``seconds`` (of an utterance), ``pool``, ``check_utterances``
(pool entries the check compares, drawn from the seed), ``stage1``,
``scene``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from aec_bench import scenes
from aec_bench.bench import load_module
from aec_bench.drivers.common import percentile, row_gap, sample, tf32, worst
from aec_bench.trace import span


class Cell:
    def __init__(self, ctx):
        from aec_tpu_torch.cli.infer import _make_enhancer
        from aec_tpu_torch.dsp.stft import StftConfig
        from aec_tpu_torch.train import checkpoints

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        self.ref = load_module(ctx.root, "reference", cfg["name"])
        self.sr = cfg["sample_rate"]
        self.n = int(round(mix["seconds"] * self.sr))
        g = scenes.generator(ctx.seed, dev)
        sc = scenes.make(g, mix["pool"], self.n, mix["scene"], dev)
        pin = dev.type == "cuda"
        self.far_pool = sc["far"].cpu().pin_memory() if pin else sc["far"].clone()
        self.mic_pool = sc["mic"].cpu().pin_memory() if pin else sc["mic"].clone()
        self.watch = sample(ctx.seed, mix["pool"], mix["check_utterances"], "infer")
        self.weights = self.ref.make_weights(cfg, ctx.seed, dev)
        self.tmp = tempfile.TemporaryDirectory(prefix="aec_bench_")
        path = os.path.join(self.tmp.name, "dccrn.npz")
        checkpoints.save(path, {"params": self.weights[0], "model_state": self.weights[1]})
        st = cfg["stft"]
        enhance, _ = _make_enhancer(cfg["net"]["family"], path, mix["stage1"],
                                    StftConfig(st["win"], st["hop"], st["fft"], st["window"]),
                                    device=dev)
        self.program = enhance
        self.far_d = torch.empty(1, self.n, device=dev)
        self.mic_d = torch.empty(1, self.n, device=dev)
        self.out_h = torch.empty(self.n, pin_memory=pin)
        self.done = torch.cuda.Event() if pin else None
        self.kept = {}
        for i in range(min(2, mix["pool"])):  # the one shape the window runs
            self.utterance(i)

    def utterance(self, i: int) -> None:
        with span("copy_in"):
            self.far_d.copy_(self.far_pool[i][None], non_blocking=True)
            self.mic_d.copy_(self.mic_pool[i][None], non_blocking=True)
        with span("enhance"):
            wav = self.program(self.far_d, self.mic_d)
        with span("copy_out"):
            self.out_h.copy_(wav[0], non_blocking=True)
        with span("wait"):
            if self.done is not None:
                self.done.record()
                self.done.synchronize()

    def window(self, seconds: float, win) -> dict:
        end, lat, k, size = win.start + seconds, [], 0, self.ctx.mix["pool"]
        while True:
            t = time.perf_counter()
            self.utterance(k % size)
            lat.append(time.perf_counter() - t)
            if k % size in self.watch:
                self.kept[k % size] = self.out_h.clone()
            k += 1
            if time.perf_counter() >= end:
                break
        wall = win.stop()
        return {"attempted": k, "failed": 0,
                "e2e": {"utt_p95_ms": 1e3 * percentile(lat, 95)},
                "work": {"utterances": k, "samples": self.n, "wall_s": wall}}

    def release(self) -> None:
        self.program = None
        self.tmp.cleanup()

    def check(self, control: bool = False) -> dict:
        """The widest gap of each compared utterance's wav from the
        reference's (Kalman, then the net in eval mode), against its mic's
        peak. ``control`` puts the reference in TF32 in the program's place."""
        cfg, dev = self.ctx.cfg, self.ctx.device
        gap, hop = 0.0, cfg["stft"]["hop"]
        compared = self.watch if control else [i for i in self.watch if i in self.kept]
        if not compared:
            return {"wav_gap": float("nan")}
        for i in compared:
            far = self.far_pool[i][None].to(dev)
            mic = self.mic_pool[i][None].to(dev)
            want = self.ref.enhance(*self.weights, cfg["kalman"], far, mic, hop)
            if control:
                with tf32(True):
                    got = self.ref.enhance(*self.weights, cfg["kalman"], far, mic, hop)
            else:
                got = self.kept[i][None].to(dev)
            gap = worst(gap, row_gap(got, want, mic.abs().amax(-1)))
        return {"wav_gap": gap}
