"""Streaming AEC CLI: a wav pair hop by hop like a live call, with the
flags and the report of ``aec_tpu/cli/stream.py``, and ``--device``.

16 ms far / mic blocks go through the two-stage streaming runtime
(``pipeline/streaming``: stage-1 Kalman or NLMS and LittleNet) one step at a
time, after one warm-up step on a zero block; the report (JSON on stdout)
gives per-block latency percentiles and the realtime margin. A block's
latency runs from its step's call to its output on the host (``.cpu()``
waits for the device). The step is the plain streaming step, as JAX's CLI
runs it; the serving kernel K3 is ``kernels/serving.py``'s.

  python -m aec_tpu_torch.cli.stream --far far.wav --mic mic.wav --out enhanced.wav \\
      [--model_file checkpoints/little_net_synthetic.npz] [--stage1 kalman] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.models.little_net import little_net_init
from aec_tpu_torch.pipeline.audio_io import read_wav, write_wav
from aec_tpu_torch.pipeline.streaming import stream_flush, stream_init, stream_step


@torch.no_grad()
def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Hop-by-hop streaming enhancement")
    p.add_argument("--far", required=True)
    p.add_argument("--mic", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model_file", default="")
    p.add_argument("--stage1", choices=("kalman", "nlms", "none"), default="kalman")
    p.add_argument("--normalize", action=argparse.BooleanOptionalAction, default=False,
                   help="causal running-stats pseudo-norm for checkpoints trained with the "
                        "reference's in-forward norm; default off = causal raw mode")
    p.add_argument("--gain-norm", action="store_true",
                   help="scale-sane ERB synthesis, for preservation-trained checkpoints, e.g. "
                        "little_net_dtalk.npz")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    far, sr = read_wav(args.far, args.sr)
    mic, _ = read_wav(args.mic, args.sr)
    n = min(len(far), len(mic))
    cfg = StftConfig()
    n = n // cfg.hop * cfg.hop
    far, mic = far[:n], mic[:n]

    dev = torch.device(args.device)
    if args.model_file:
        from aec_tpu_torch.cli.infer import load_params

        net = load_params(args.model_file, device=dev)
    else:
        net = little_net_init(generator=torch.Generator().manual_seed(0), device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    lin_cfg = {"kalman": KalmanConfig(), "nlms": NlmsConfig(), "none": None}[args.stage1]
    kw = dict(stage1=args.stage1, lin_cfg=lin_cfg, normalize=args.normalize,
              gain_norm=args.gain_norm)

    state = stream_init(cfg=cfg, stage1=args.stage1, lin_cfg=lin_cfg, device=dev)
    # warm-up on a zero block, its result discarded, so the live loop starts warm
    zero = torch.zeros(cfg.hop, device=dev)
    stream_step(net, state, zero, zero, erb, cfg, **kw)[1].cpu()

    outs, lat = [], []
    for lo in range(0, n, cfg.hop):
        f = torch.from_numpy(far[lo : lo + cfg.hop]).to(dev)
        m = torch.from_numpy(mic[lo : lo + cfg.hop]).to(dev)
        t0 = time.perf_counter()
        state, out = stream_step(net, state, f, m, erb, cfg, **kw)
        out = out.cpu().numpy()  # waits for the device: this is the block latency
        lat.append(time.perf_counter() - t0)
        outs.append(out)
    outs.append(stream_flush(net, state, erb, cfg, normalize=args.normalize,
                             gain_norm=args.gain_norm).cpu().numpy())
    wav = np.concatenate(outs)[cfg.hop :][:n]  # drop the trimmed left edge
    write_wav(args.out, wav.astype(np.float32), sr)

    lat_ms = np.asarray(lat[1:]) * 1e3  # the first block left out
    block_ms = cfg.hop / sr * 1e3
    report = {
        "blocks": len(lat),
        "block_ms": block_ms,
        "latency_ms_p50": round(float(np.percentile(lat_ms, 50)), 3),
        "latency_ms_p95": round(float(np.percentile(lat_ms, 95)), 3),
        "realtime": bool(np.percentile(lat_ms, 95) < block_ms),
        "algorithmic_latency_ms": block_ms,
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
