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
a batch holds one utterance.

``--mesh`` splits each batch over the ranks that ``AEC_COORDINATOR`` /
``AEC_NUM_PROCESSES`` / ``AEC_PROCESS_ID`` describe (one process per rank,
NCCL with ``--device cuda``, gloo with ``--device cpu``; JAX shards one
process's batch over its devices instead): the batch is padded with silent
rows to a multiple of the data axis, each rank enhances its contiguous
rows, and rank 0 gathers them and writes the files and the report. Every
utterance is normalized on its own, so the output equals the run without
``--mesh``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.linear.nlms import nlms_cancel
from aec_tpu_torch.models.little_net import little_net_apply
from aec_tpu_torch.pipeline.audio_io import write_wav
from aec_tpu_torch.pipeline.datasets import EvalLoader
from aec_tpu_torch.pipeline.h5io import read_filelist
from aec_tpu_torch.utils.tools import get_logger

logger = get_logger(__name__)


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

    started, mesh = False, None
    if args.mesh:
        from aec_tpu_torch.parallel.mesh import distributed_init_if_needed, make_mesh

        started = distributed_init_if_needed(device=args.device)
        mesh = make_mesh()
        logger.info("mesh: %d ranks on the data axis", mesh.shape["data"])
    try:
        _enhance(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _enhance(args: argparse.Namespace, mesh) -> None:
    from aec_tpu_torch.cli.infer import load_params
    from aec_tpu_torch.parallel.mesh import is_primary, local_rows

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

    def enhance(far, mic):
        """The batch's wavs on the host; with a mesh each rank runs its
        rows of the padded batch and the rows are gathered."""
        if mesh is None:
            wav = pipeline(torch.from_numpy(far).to(dev), torch.from_numpy(mic).to(dev))
            return wav.cpu().numpy()  # waits for the device: the window ends with the readback
        b = far.shape[0]
        pad = -b % mesh.shape["data"]  # pad to a shardable batch
        far, mic = (np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
                    for x in (far, mic))
        rows = local_rows(mesh, b + pad)
        wav = pipeline(torch.from_numpy(far[rows]).to(dev), torch.from_numpy(mic[rows]).to(dev))
        group = mesh.group("data")
        if group is not None:
            parts = [torch.empty_like(wav) for _ in range(mesh.shape["data"])]
            dist.all_gather(parts, wav.contiguous(), group=group)
            wav = torch.cat(parts)
        return wav.cpu().numpy()[:b]

    primary = is_primary()
    if primary:
        os.makedirs(args.out_dir, exist_ok=True)
    total_audio_s, total_wall, total_utts = 0.0, 0.0, 0
    for tt_file in read_filelist(args.tt_list):
        loader = EvalLoader(tt_file, batch_size=args.batch, bucket_quantum=args.bucket)
        for bi, egs in enumerate(loader):
            mic, far = egs["nearend_mic"], egs["farend_speech"]
            b = mic.shape[0]
            t0 = time.perf_counter()
            wav = enhance(far, mic)
            dt = time.perf_counter() - t0
            total_wall += dt
            total_audio_s += b * mic.shape[1] / args.sr
            for j in range(b if primary else 0):
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
    if primary:
        print(json.dumps(report))


if __name__ == "__main__":
    main()
