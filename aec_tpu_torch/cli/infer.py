"""Inference / enhancement CLI: the flags and outputs of ``aec_tpu/cli/infer.py``, and ``--device``.

Per utterance of each test ``.ex`` file, runs the selected post-filter
family, optionally after a stage-1 linear canceller, and writes five wavs:
``{k}_near_est/near/far/mic/echo.wav`` at 16 kHz.

  python -m aec_tpu_torch.cli.infer --tt_list lists/tt_list.txt --ckpt_dir exp \\
      --model_file exp/models/best_loss.npz --est_path out \\
      [--model little_net|two_layer_gru|fullsubnet|dccrn|att_ccrn] [--stage1 kalman] \\
      [--lstm_dtype auto|int8|bf16|f32] [--device cpu]

Checkpoints are the framework's path-keyed ``.npz`` files (either package
writes them) and, for little_net, the reference's pickled ``.pt``
(``utils/torch_compat``). On the card, stage 1 runs its batched kernel (K1
or K5) on the loader's (1, n) batches; LittleNet's and
TwoLayerGRU's GRU at batch 1 runs on K8, DCCRN's two complex-LSTM layers on
K9, FullSubNet's joint full/sub-band recurrence on K11, and ATT-CCRN's
bottleneck LSTM on K10 (``--lstm_dtype auto`` is int8 on a CUDA device, f32
on the CPU, as JAX's is int8 on its accelerator only).
"""

from __future__ import annotations

import argparse
import os
import pprint

import numpy as np
import torch

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.linear.nlms import nlms_cancel
from aec_tpu_torch.pipeline.audio_io import write_wav
from aec_tpu_torch.pipeline.datasets import EvalLoader
from aec_tpu_torch.pipeline.h5io import read_filelist
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.utils import profiling
from aec_tpu_torch.utils.tools import get_logger, num_params


def load_params(model_file: str, *, device="cuda"):
    """LittleNet on ``device`` from a framework ``.npz`` checkpoint or a
    reference ``.pt``."""
    if model_file.endswith(".pt"):
        from aec_tpu_torch.utils.torch_compat import (
            little_net_params_from_state_dict,
            load_reference_checkpoint,
        )

        _, state = load_reference_checkpoint(model_file)
        return little_net_params_from_state_dict(state, device=device)
    from aec_tpu_torch.utils.weights import load_npz

    return load_npz(model_file, device=device)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree, dtype=np.float32), device=device)


def _make_enhancer(
    model: str, model_file: str, stage1: str, scfg: StftConfig,
    normalize: bool = True, align_far_ms: float = 0.0,
    lstm_dtype: str = "auto", gain_norm: bool = False, *, device="cuda",
):
    """Returns (enhance(far [B, n], mic [B, n]) -> wav [B, n], params),
    loading the weights onto ``device`` (the card unless the caller asks for
    the CPU). ``normalize`` is the reference Tester's in-forward pseudo-norm,
    LittleNet only. ``lstm_dtype`` is ATT-CCRN's bottleneck recurrence:
    "auto" is int8 on a CUDA device (kernel K10) and f32 elsewhere, as JAX's
    is int8 on the TPU only. Spans (``utils/profiling``): ``enhance`` around
    a call, ``enhance.stage1`` (the alignment and the linear canceller) and
    ``enhance.net`` inside it."""
    if model != "little_net" and model_file.endswith(".pt"):
        raise ValueError(
            f".pt checkpoint interop is little_net-only (reference .pt files hold Little_net "
            f"weights); --model {model} needs a framework .npz checkpoint"
        )
    lin_cfg = {"kalman": KalmanConfig(), "nlms": NlmsConfig(), "none": None}[stage1]
    # the GCC-PHAT search window: the requested range plus the guard's headroom
    max_shift = int(align_far_ms / 1e3 * 16000) + 512

    def prealign(far, mic):
        """The (possibly aligned) far end both stages see."""
        if align_far_ms <= 0:
            return far
        from aec_tpu_torch.dsp.delay import estimate_and_align

        return estimate_and_align(far, mic, max_delay=max_shift, block=scfg.hop)[0]

    def stage1_fn(far, mic):
        if stage1 == "kalman":
            return kalman_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
        if stage1 == "nlms":
            return nlms_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
        return mic

    if model in ("little_net", "two_layer_gru"):
        erb = torch.as_tensor(erb_filterbank(), device=device)
        if model == "little_net":
            from aec_tpu_torch.models.little_net import little_net_apply as apply_fn

            params = load_params(model_file, device=device)
        else:
            from aec_tpu_torch.models.two_layer_gru import TwoLayerGru, two_layer_gru_apply
            from aec_tpu_torch.utils.weights import two_layer_gru_from_jax, two_layer_gru_to_jax

            template = {"params": two_layer_gru_to_jax(TwoLayerGru())}
            params = two_layer_gru_from_jax(
                checkpoints.restore(model_file, template)["params"], device=device)
            apply_fn = lambda p, m, f, e, c, **kw: two_layer_gru_apply(p, m, f, e, c)  # noqa: E731
            if gain_norm:
                raise ValueError("--gain-norm is little_net-only (the ERB synthesis quirk "
                                 "lives in ERB.py:306-310)")

        @torch.no_grad()
        def enhance(far, mic):
            with profiling.span("enhance"):
                with profiling.span("enhance.stage1"):
                    far = prealign(far, mic)
                    lin = stage1_fn(far, mic)
                with profiling.span("enhance.net"):
                    return apply_fn(params, lin, far, erb, scfg, normalize=normalize,
                                    gain_norm=gain_norm)["wav"]

        return enhance, params

    if model not in ("dccrn", "fullsubnet", "att_ccrn"):
        raise KeyError(f"no inference adapter for model {model!r}")
    from aec_tpu_torch.train.generic import make_adapter

    adapter = make_adapter(model, scfg)
    p0, s0 = adapter.init(device="cpu")
    restored = checkpoints.restore(model_file, {"params": p0, "model_state": s0})
    params = _tree_to(restored["params"], device)
    model_state = _tree_to(restored["model_state"], device)

    if model == "fullsubnet":
        from aec_tpu_torch.models.fullsubnet import FullSubNetConfig, fullsubnet_apply

        cfg = FullSubNetConfig()

        def post(lin, far):
            return fullsubnet_apply(params, lin, far, cfg)["wav"]
    elif model == "dccrn":
        from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_apply

        cfg = DccrnConfig()

        def post(lin, far):
            return dccrn_apply(params, model_state, lin, far, cfg, train=False)[0]["wav"]
    else:
        from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply

        cfg = AttCcrnConfig()
        # int8 recurrent weights on the card (K10), f32 on the CPU; JAX's auto
        # is int8 on its TPU only. Training paths never take int8 (its
        # rounding has no gradient).
        if lstm_dtype == "auto":
            rd = "int8" if torch.device(device).type == "cuda" else None
        else:
            rd = {"int8": "int8", "bf16": torch.bfloat16, "f32": torch.float32}[lstm_dtype]

        def post(lin, far):
            return att_ccrn_apply(params, model_state, lin, far, cfg, train=False,
                                  lstm_recurrent_dtype=rd)[0]["wav"]

    @torch.no_grad()
    def enhance(far, mic):
        with profiling.span("enhance"):
            with profiling.span("enhance.stage1"):
                far = prealign(far, mic)
                lin = stage1_fn(far, mic)
            with profiling.span("enhance.net"):
                return post(lin, far)

    return enhance, params


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Enhance test utterances and dump wavs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--tt_list", type=str, required=True)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--model_file", type=str, required=True)
    p.add_argument("--est_path", type=str, required=True)
    p.add_argument("--filename_list", type=str, default="")
    p.add_argument("--model", type=str, default="little_net",
                   choices=("little_net", "two_layer_gru", "fullsubnet", "dccrn", "att_ccrn"))
    p.add_argument("--stage1", choices=("none", "kalman", "nlms"), default="none",
                   help="optional linear AEC before the post-filter")
    p.add_argument("--align-far-ms", type=float, default=0.0,
                   help="if > 0, estimate each utterance's far/mic bulk delay up to this many "
                        "ms (GCC-PHAT, dsp/delay.py) and pre-align the far end before stage 1")
    p.add_argument("--normalize", action=argparse.BooleanOptionalAction, default=True,
                   help="apply the reference's in-forward pseudo-norm (the Tester default); "
                        "little_net only")
    p.add_argument("--gain-norm", action="store_true",
                   help="little_net only: scale-sane ERB synthesis")
    p.add_argument("--lstm_dtype", choices=("auto", "int8", "bf16", "f32"), default="auto",
                   help="att_ccrn only: the bottleneck LSTM's recurrent weights. auto = int8 on "
                        "a CUDA device (kernel K10; the JAX package grades int8 >= 71 dB wav "
                        "SNR against bf16 on its 8 scenes), f32 elsewhere; bf16 and f32 run "
                        "the plain per-step loop")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    args = p.parse_args(argv)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    log = get_logger(os.path.join(args.ckpt_dir, "test.log"), log_file=True)
    log.info("Arguments:\n%s", pprint.pformat(vars(args)))

    scfg = StftConfig()
    dev = torch.device(args.device)
    try:
        enhance, params = _make_enhancer(
            args.model, args.model_file, args.stage1, scfg,
            normalize=args.normalize, align_far_ms=args.align_far_ms,
            lstm_dtype=args.lstm_dtype, gain_norm=args.gain_norm, device=dev,
        )
        log.info("Loaded %s from %s", args.model, args.model_file)
    except FileNotFoundError:
        if args.model != "little_net":
            raise
        # the reference tolerates a missing checkpoint for the default model: fresh init
        from aec_tpu_torch.models.little_net import little_net_apply, little_net_init

        params = little_net_init(generator=torch.Generator().manual_seed(0), device=dev)
        erb = torch.as_tensor(erb_filterbank(), device=dev)
        lin_cfg = {"kalman": KalmanConfig(), "nlms": NlmsConfig(), "none": None}[args.stage1]

        @torch.no_grad()
        def enhance(far, mic):
            if args.stage1 == "kalman":
                lin = kalman_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
            elif args.stage1 == "nlms":
                lin = nlms_cancel(lin_cfg, far, mic, block=scfg.hop)["wav"]
            else:
                lin = mic
            return little_net_apply(params, lin, far, erb, scfg, normalize=args.normalize)["wav"]

        log.info("No checkpoint at %s; using fresh init", args.model_file)
    log.info("Trainable parameter count: {:,d}".format(num_params(params)))

    for tt_file in read_filelist(args.tt_list):
        sub = os.path.join(args.est_path, os.path.basename(tt_file).replace(".ex", ""))
        os.makedirs(sub, exist_ok=True)
        loader = EvalLoader(tt_file, batch_size=1, bucket_quantum=scfg.hop)
        log.info("Estimating on %s (%d utts)", tt_file, loader.n)
        for k, egs in enumerate(loader):
            n = egs["n_samples"]
            wav = enhance(torch.from_numpy(egs["farend_speech"]).to(dev),
                          torch.from_numpy(egs["nearend_mic"]).to(dev))
            est = wav.cpu().numpy()[0][:n]
            if len(est) < n:  # hop-mismatch tail
                est = np.pad(est, (0, n - len(est)))
            write_wav(os.path.join(sub, f"{k}_near_est.wav"), est, args.sr)
            write_wav(os.path.join(sub, f"{k}_near.wav"), egs["nearend_speech"][0][:n], args.sr)
            write_wav(os.path.join(sub, f"{k}_far.wav"), egs["farend_speech"][0][:n], args.sr)
            write_wav(os.path.join(sub, f"{k}_mic.wav"), egs["nearend_mic"][0][:n], args.sr)
            write_wav(os.path.join(sub, f"{k}_echo.wav"), egs["echo"][0][:n], args.sr)


if __name__ == "__main__":
    main()
