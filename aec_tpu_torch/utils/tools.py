"""Logging / accounting utilities (``aec_tpu/utils/tools.py``, the
reference's scripts/utils/tools.py)."""

from __future__ import annotations

import json
import logging
import os

import numpy as np


def get_logger(
    name: str,
    *,
    log_file: bool = False,
    fmt: str = "%(asctime)s [%(pathname)s:%(lineno)s - %(levelname)s ] %(message)s",
    datefmt: str = "%Y-%m-%d %H:%M:%S",
) -> logging.Logger:
    """Console or file logger at INFO."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.FileHandler(name) if log_file else logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt=fmt, datefmt=datefmt))
        logger.addHandler(handler)
    return logger


def num_params(params) -> int:
    """Total parameter count of an ``nn.Module`` or of a tree (dicts,
    lists, tuples) of tensors or arrays, as the JAX package counts a
    pytree's leaves."""
    if hasattr(params, "parameters"):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(num_params(v) for v in params)
    return int(np.prod(np.shape(params)))


def count_frames(n_samples: int, win_size: int, hop_size: int) -> int:
    """Frame-count formula used for loss weighting (the reference's
    countFrames). It does NOT equal the STFT frame count (n // hop + 1); it
    is kept verbatim because it only weights loss averaging."""
    n_overlap = win_size // hop_size
    return int((n_samples - n_overlap) // hop_size) + 1


def loss_mask(shape, n_frames) -> np.ndarray:
    """Per-sequence frame validity mask: 1.0 for frames < seq_len, else 0.
    ``shape`` = (B, T, F)."""
    mask = np.zeros(shape, dtype=np.float32)
    for i, seq_len in enumerate(n_frames):
        mask[i, : int(seq_len), :] = 1.0
    return mask


def loss_log(path: str, ckpt_info: dict, metrics: dict) -> None:
    """Append an epoch/iter metrics record in the reference's format."""
    with open(path, "a") as f:
        f.write(
            "cur_epoch={}, cur_iter={} [\n\t".format(
                ckpt_info["cur_epoch"] + 1, ckpt_info["cur_iter"] + 1
            )
        )
        for k, v in metrics.items():
            f.write(f"{k} = {v:.4f}, ")
        f.write("\n]\n")


def dump_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, sort_keys=True)


def load_json(path: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no json file at {path}")
    with open(path) as f:
        return json.load(f)
