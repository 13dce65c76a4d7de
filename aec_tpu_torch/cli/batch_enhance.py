"""Bulk two-stage enhancement over utterance sets, with the flags, file
names and report of ``aec_tpu/cli/batch_enhance.py``, and ``--device``.

Every utterance of the listed test ``.ex`` files goes through stage 1
(Kalman or NLMS) and the LittleNet post-filter in batches of ``--batch``,
written as ``<k>_enhanced.wav``, with a throughput report (JSON) on stdout.

  python -m aec_tpu_torch.cli.batch_enhance --tt_list lists/tt_list.txt \\
      --model_file exp/models/best_loss.npz --out_dir enhanced \\
      [--batch 64] [--stage1 kalman] [--device cpu]

On the card a batch runs stage 1 as one launch of its batched kernel (K1
for Kalman, K5 for NLMS) and the post-filter offline, its GRU on K8 where
a batch holds one utterance. ``--mesh`` (the parallel layer, ROADMAP A6)
exits with an error naming the item that brings it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.linear.nlms import nlms_cancel
from aec_tpu_torch.models.little_net import little_net_apply
from aec_tpu_torch.pipeline.audio_io import write_wav
from aec_tpu_torch.pipeline.datasets import EvalLoader
from aec_tpu_torch.pipeline.h5io import read_filelist


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Bulk two-stage enhancement")
    p.add_argument("--tt_list", required=True)
    p.add_argument("--model_file", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--stage1", choices=("kalman", "nlms", "none"), default="kalman")
    p.add_argument("--normalize", action=argparse.BooleanOptionalAction, default=True,
                   help="the reference Tester's pseudo-norm, per utterance so each batched "
                        "result equals a batch-1 run; --no-normalize for the causal mode")
    p.add_argument("--gain-norm", action="store_true",
                   help="scale-sane ERB synthesis, for preservation-trained checkpoints")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--bucket", type=int, default=16384, help="length quantum")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)
    if args.mesh:
        p.error("--mesh: the port's parallel layer is ROADMAP item A6")

    from aec_tpu_torch.cli.infer import load_params

    dev = torch.device(args.device)
    net = load_params(args.model_file, device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    scfg = StftConfig()
    lin_cfg = {"kalman": KalmanConfig(), "nlms": NlmsConfig(), "none": None}[args.stage1]

    @torch.no_grad()
    def pipeline(far, mic):
        if args.stage1 == "kalman":
            lin = kalman_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
        elif args.stage1 == "nlms":
            lin = nlms_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
        else:
            lin = mic
        return little_net_apply(net, lin, far, erb, scfg, normalize=args.normalize,
                                per_utt_norm=True, gain_norm=args.gain_norm)["wav"]

    os.makedirs(args.out_dir, exist_ok=True)
    total_audio_s, total_wall, total_utts = 0.0, 0.0, 0
    for tt_file in read_filelist(args.tt_list):
        loader = EvalLoader(tt_file, batch_size=args.batch, bucket_quantum=args.bucket)
        for bi, egs in enumerate(loader):
            mic, far = egs["nearend_mic"], egs["farend_speech"]
            b = mic.shape[0]
            t0 = time.perf_counter()
            wav = pipeline(torch.from_numpy(far).to(dev), torch.from_numpy(mic).to(dev))
            wav = wav.cpu().numpy()  # waits for the device: the window ends with the readback
            dt = time.perf_counter() - t0
            total_wall += dt
            total_audio_s += b * mic.shape[1] / args.sr
            for j in range(b):
                k = bi * args.batch + j
                write_wav(os.path.join(args.out_dir, f"{k}_enhanced.wav"),
                          wav[j][: egs["n_samples"]], args.sr)
            total_utts += b
    report = {
        "utterances": total_utts,
        "audio_seconds": round(total_audio_s, 1),
        "wall_seconds": round(total_wall, 3),
        "xrt": round(total_audio_s / max(total_wall, 1e-9), 1),
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
