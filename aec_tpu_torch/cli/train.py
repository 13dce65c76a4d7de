"""Training CLI with the arguments of ``aec_tpu/cli/train.py``, plus
``--device``:

  python -m aec_tpu_torch.cli.train --tr_list lists/tr_list.txt --cv_file cv.ex \\
      --ckpt_dir exp [--resume_model exp/models/latest.npz] [--device cpu]

Routes as the JAX CLI does: little_net and two_layer_gru train on the
reference-cadence ``Trainer`` with the registry's loss and init, dccrn,
fullsubnet and att_ccrn on ``GenericTrainer``. ``--device_cache`` holds the
corpus in device memory for the reference-cadence families and is refused
for the others with JAX's message. ``--mesh`` trains data-parallel over the
ranks that ``AEC_COORDINATOR`` / ``AEC_NUM_PROCESSES`` / ``AEC_PROCESS_ID``
describe (one process per rank, ``parallel/mesh.py``; NCCL with
``--device cuda``, one card a rank, gloo with ``--device cpu``), each rank
reading its shard of the list at the global batch over the ranks, the step
JAX's on the global batch, rank 0 writing the checkpoints.
"""

from __future__ import annotations

import argparse
import pprint

import torch.distributed as dist

from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.models.registry import get_model
from aec_tpu_torch.pipeline.h5io import read_filelist
from aec_tpu_torch.train.generic import GenericTrainer
from aec_tpu_torch.train.loop import Trainer
from aec_tpu_torch.utils.tools import get_logger


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Train the stage-2 post-filter",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--tr_list", type=str, required=True, help="training .ex filelist")
    p.add_argument("--cv_file", type=str, required=True, help="grouped cv .ex file")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--time_log", type=str, default="")
    p.add_argument("--loss_log", type=str, default="loss.txt")
    p.add_argument("--resume_model", type=str, default="")
    p.add_argument("--mesh", action="store_true", help="shard batches over all devices")
    p.add_argument("--model", type=str, default="little_net",
                   choices=("little_net", "two_layer_gru", "fullsubnet", "dccrn", "att_ccrn"),
                   help="model family; little_net/two_layer_gru use the reference-cadence "
                        "Trainer, the rest the generic stateful trainer")
    p.add_argument("--lr", type=float, default=TrainConfig.lr)
    p.add_argument("--batch_size", type=int, default=TrainConfig.batch_size)
    p.add_argument("--max_n_epochs", type=int, default=TrainConfig.max_n_epochs)
    p.add_argument("--validate_metrics", type=str, default="",
                   help="comma list of extra cv metrics (stoi,sisdr); each gets a "
                        "best_<metric>.npz slot")
    p.add_argument("--device_cache", type=str, default="",
                   choices=("", "int16", "bfloat16", "float32"),
                   help="cache the whole corpus in device memory")
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    args = p.parse_args(argv)

    logger = get_logger(__name__)
    logger.info("Arguments:\n%s", pprint.pformat(vars(args)))
    started = False
    if args.mesh:
        # the ranks' group when a coordinator is configured (AEC_COORDINATOR
        # / AEC_NUM_PROCESSES / AEC_PROCESS_ID); a no-op on one process.
        # Before anything touches the device: on CUDA it picks the rank's card
        from aec_tpu_torch.parallel.mesh import distributed_init_if_needed

        started = distributed_init_if_needed(device=args.device)
        if started:
            logger.info("torch.distributed up: process %d/%d, backend %s",
                        dist.get_rank(), dist.get_world_size(), dist.get_backend())
    try:
        _train(p, args)
    finally:
        if started:
            dist.destroy_process_group()


def _train(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    cfg = TrainConfig(lr=args.lr, batch_size=args.batch_size, max_n_epochs=args.max_n_epochs)
    validate_metrics = tuple(m for m in args.validate_metrics.split(",") if m)
    if args.model not in ("little_net", "two_layer_gru"):
        if args.device_cache:
            p.error(
                "--device_cache supports the reference-cadence families "
                "(little_net, two_layer_gru); the stateful trainer keeps "
                "the host loader"
            )
        GenericTrainer(
            model=args.model,
            tr_list=read_filelist(args.tr_list),
            cv_file=args.cv_file,
            ckpt_dir=args.ckpt_dir,
            cfg=cfg,
            resume_model=args.resume_model,
            use_mesh=args.mesh,
            time_log=args.time_log,
            validate_metrics=validate_metrics,
            device=args.device,
        ).train()
        return

    spec = get_model(args.model)
    Trainer(
        tr_list=read_filelist(args.tr_list),
        cv_file=args.cv_file,
        ckpt_dir=args.ckpt_dir,
        cfg=cfg,
        resume_model=args.resume_model,
        time_log=args.time_log,
        loss_log_name=args.loss_log,
        use_mesh=args.mesh,
        loss_fn=spec.loss,
        init_fn=spec.init,
        validate_metrics=validate_metrics,
        device_cache=args.device_cache,
        device=args.device,
    ).train()


if __name__ == "__main__":
    main()
