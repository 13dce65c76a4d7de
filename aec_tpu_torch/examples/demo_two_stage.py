"""End-to-end demo: a synthetic echo scene through both stages, wavs and a
report, the port's ``examples/demo_two_stage.py``: the same flags, scene,
files and report, plus ``--device``.

  python -m aec_tpu_torch.examples.demo_two_stage [--out_dir demo_out] [--seconds 8] \
      [--model_file checkpoints/little_net_synthetic.npz] [--device cpu]

The scene is numpy-made from fixed seeds, so it is JAX's sample for sample:
far-end speech-shaped noise through a decaying room impulse response, plus
near-end speech-shaped noise. ``two_stage_cancel`` runs it as one
utterance (on the card: the single-stream Kalman kernel K6, then K2 as a
batch of one), and the report gives the echo-only ERLE of stage 1 and of
both stages (the same scene without its near end), the double-talk SI-SNR
of the linear and the enhanced output, each over the second half, and the
realtime factor ``xrt`` (audio seconds per wall second, the best of three
runs, each ending in a readback). ``--model_file ''`` takes a random net
(``torch.Generator`` seed 0: not JAX's random net).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models.little_net import little_net_init
from aec_tpu_torch.pipeline.audio_io import write_wav
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.train.metrics import erle, si_snr

SR = 16000
DEFAULT_MODEL = os.path.join(os.path.dirname(__file__), "..", "..", "checkpoints",
                             "little_net_synthetic.npz")


def speech_shaped_noise(rng, n, sr=SR):
    """White noise shaped by a crude 1/f speech-like spectral tilt + 4 Hz
    syllabic envelope."""
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1 / sr)
    tilt = 1.0 / np.maximum(f / 500.0, 1.0)
    shaped = np.fft.irfft(spec * tilt, n=n)
    env = 0.5 + 0.5 * np.clip(np.sin(2 * np.pi * 4.0 * np.arange(n) / sr), 0, None)
    out = shaped * env
    return (out / np.max(np.abs(out))).astype(np.float32)


def make_scene(seconds: float, echo_gain: float = 0.7) -> dict[str, np.ndarray]:
    """``{"far", "echo", "near", "mic"}`` float32 of ``seconds`` (cut to
    whole 256-sample hops), from ``default_rng(0)`` and ``(1)``."""
    n = int(seconds * SR) // 256 * 256
    rng = np.random.default_rng(0)
    far = speech_shaped_noise(rng, n)
    rir = (np.exp(-np.arange(1600) / 300.0) * rng.standard_normal(1600)).astype(np.float32)
    rir = echo_gain * rir / np.max(np.abs(rir))
    echo = np.convolve(far, rir)[:n].astype(np.float32)
    near = 0.3 * speech_shaped_noise(np.random.default_rng(1), n)
    return {"far": far, "echo": echo, "near": near, "mic": (echo + near).astype(np.float32)}


def run_demo(net, scene: dict[str, np.ndarray], seconds: float, device) -> tuple[dict, dict]:
    """(report, wavs) of the scene through ``two_stage_cancel`` on
    ``device`` (``net`` there already)."""
    erb = torch.as_tensor(erb_filterbank(), device=device)
    far, mic, echo = (torch.as_tensor(scene[k], device=device) for k in ("far", "mic", "echo"))

    def cancel(m):
        return two_stage_cancel(net, far, m, erb, stage1="kalman", lin_cfg=KalmanConfig())

    out = cancel(mic)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        cancel(mic)["wav"][:4].cpu()  # the readback waits for the device
        times.append(time.perf_counter() - t0)
    dt = min(times)

    # the echo-only variant of the same scene: ERLE means something there
    # (in double talk, keeping the near end rightly LOWERS ERLE)
    out_e = cancel(echo)
    n = far.shape[-1]
    tail = slice(n // 2, None)
    near = torch.as_tensor(scene["near"], device=device)
    report = {
        "echo_only_erle_stage1_db": round(float(erle(echo[tail], out_e["linear_wav"][tail])), 2),
        "echo_only_erle_two_stage_db": round(float(erle(echo[tail], out_e["wav"][tail])), 2),
        "double_talk_sisnr_linear_db": round(float(si_snr(out["linear_wav"][tail], near[tail])), 2),
        "double_talk_sisnr_enhanced_db": round(float(si_snr(out["wav"][tail], near[tail])), 2),
        "xrt": round(seconds / dt, 1),
    }
    wavs = {"far": scene["far"], "mic": scene["mic"], "near": scene["near"],
            "linear": out["linear_wav"].cpu().numpy(), "enhanced": out["wav"].cpu().numpy()}
    return report, wavs


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--model_file", default=DEFAULT_MODEL,
                   help="trained checkpoint (.npz or reference .pt); '' = random init")
    p.add_argument("--echo_gain", type=float, default=0.7)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    if args.model_file:
        from aec_tpu_torch.cli.infer import load_params

        net = load_params(args.model_file, device=dev)
    else:
        net = little_net_init(generator=torch.Generator().manual_seed(0), device=dev)
    report, wavs = run_demo(net, make_scene(args.seconds, args.echo_gain), args.seconds, dev)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, wav in wavs.items():
        write_wav(os.path.join(args.out_dir, f"{name}.wav"), wav, SR)
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
