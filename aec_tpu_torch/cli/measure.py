"""Metric CLI with the flags and the JSON of ``aec_tpu/cli/measure.py``:
scores enhanced utterances written by ``aec_tpu_torch.cli.infer`` (the
``{k}_near_est/near/mic`` naming) or one explicit file pair.

  python -m aec_tpu_torch.cli.measure --est_dir out/test [--metrics stoi,sisnr,erle,snr]
  python -m aec_tpu_torch.cli.measure --est path/a.wav --ref path/b.wav
  python -m aec_tpu_torch.cli.measure --est a.wav --ref b.wav --metrics pesq \\
      --allow-approx-pesq

``--metrics pesq`` uses an external reference implementation (the ``pesq``
package of the ITU ANSI-C code) when one is installed, else only with
``--allow-approx-pesq`` the bundled from-spec P.862 model
(``train/pesq.py``, uncertified); the report names which one scored.
The metrics are computed on the host (CPU tensors and numpy).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from aec_tpu_torch.pipeline.audio_io import read_wav
from aec_tpu_torch.train.metrics import erle, si_snr, snr
from aec_tpu_torch.train.stoi import stoi

ALL_METRICS = ("stoi", "sisnr", "erle", "snr")


def score_pair(
    est, ref, mic=None, metrics=ALL_METRICS, *, sr=16000, allow_approx_pesq=False,
) -> dict[str, float]:
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    out = {}
    if "stoi" in metrics:
        out["stoi"] = stoi(ref, est)
    if "sisnr" in metrics:
        out["sisnr"] = float(si_snr(torch.as_tensor(est), torch.as_tensor(ref)))
    if "snr" in metrics:
        out["snr"] = float(snr(torch.as_tensor(est), torch.as_tensor(ref)))
    if "erle" in metrics and mic is not None:
        out["erle"] = float(erle(torch.as_tensor(mic[:n]), torch.as_tensor(est)))
    if "pesq" in metrics:
        from aec_tpu_torch.train.pesq import pesq_score

        try:
            out.update(pesq_score(ref, est, sr, allow_fallback=allow_approx_pesq))
        except RuntimeError as exc:
            raise SystemExit(str(exc)) from None
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Score enhanced speech")
    p.add_argument("--est_dir", type=str, default="", help="cli.infer output dir")
    p.add_argument("--est", type=str, default="", help="single enhanced wav")
    p.add_argument("--ref", type=str, default="", help="single clean reference wav")
    p.add_argument("--mic", type=str, default="", help="optional mic wav (for ERLE)")
    p.add_argument("--metrics", type=str, default="stoi,sisnr,erle,snr")
    p.add_argument(
        "--allow-approx-pesq", action="store_true",
        help="permit the bundled from-spec P.862 model when no external reference "
             "implementation is installed (uncertified scores; see "
             "aec_tpu_torch/train/pesq.py)",
    )
    p.add_argument("--json_out", type=str, default="")
    args = p.parse_args(argv)
    metrics = tuple(m.strip() for m in args.metrics.split(","))
    kw = dict(metrics=metrics, allow_approx_pesq=args.allow_approx_pesq)

    results = []
    if args.est_dir:
        for est_path in sorted(glob.glob(os.path.join(args.est_dir, "*_near_est.wav"))):
            k = os.path.basename(est_path).split("_")[0]
            mic_path = os.path.join(args.est_dir, f"{k}_mic.wav")
            est = read_wav(est_path)[0]
            ref = read_wav(os.path.join(args.est_dir, f"{k}_near.wav"))[0]
            mic = read_wav(mic_path)[0] if os.path.isfile(mic_path) else None
            results.append({"id": k, **score_pair(est, ref, mic, **kw)})
    else:
        est = read_wav(args.est)[0]
        ref = read_wav(args.ref)[0]
        mic = read_wav(args.mic)[0] if args.mic else None
        results.append({"id": os.path.basename(args.est), **score_pair(est, ref, mic, **kw)})

    summary = {
        m: float(np.nanmean([r[m] for r in results if m in r]))
        for m in metrics
        if any(m in r for r in results)
    }
    report = {"utterances": results, "mean": summary}
    print(json.dumps(report, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
