"""Pickle-free tree checkpoints with latest/best semantics, in the format of
``aec_tpu/train/checkpoints.py`` both ways.

A checkpoint is an ``.npz`` whose entries are the leaves of a tree keyed by
their tree path as ``jax.tree_util.keystr`` writes it: a dict key as
``['key']``, a list or tuple index as ``[i]``, a namedtuple field as
``.field`` (optax's states), e.g. ``['params']['gru']['w_ih']`` or
``['opt_state'][0][0].mu['lin1']['b']``. So the JAX package restores a
checkpoint the port wrote, and the port resumes from one JAX wrote. Writes
are atomic (tmp + rename); ``<name>.json`` beside it carries ``ckpt_info``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable

import numpy as np
import torch


def tree_map_with_path(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; dicts, lists,
    tuples and namedtuples are nodes, everything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(getattr(tree, f), fn, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, ckpt_info: dict | None = None) -> None:
    """Atomically write ``tree`` to ``path`` (.npz) (+ .json sidecar)."""
    payload: dict[str, np.ndarray] = {}
    tree_map_with_path(tree, lambda key, leaf: payload.__setitem__(key, _as_numpy(leaf)))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if ckpt_info is not None:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        os.close(fd)
        with open(tmp, "w") as f:
            json.dump(ckpt_info, f, indent=2, sort_keys=True)
        os.replace(tmp, _info_path(path))


def restore(path: str, template):
    """Load leaves from ``path`` into the structure of ``template`` as numpy
    arrays. Every leaf path in ``template`` must exist in the checkpoint;
    extra entries (e.g. optimizer state when restoring params only) are
    ignored."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    with np.load(path) as data:
        def load(key, _leaf):
            if key not in data:
                raise KeyError(f"checkpoint {path} is missing leaf {key}")
            return data[key]

        return tree_map_with_path(template, load)


def load_info(path: str) -> dict:
    p = _info_path(path)
    if not os.path.isfile(p):
        return {}
    with open(p) as f:
        return json.load(f)


def _info_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".json"


def save_latest_best(
    ckpt_dir: str,
    tree,
    ckpt_info: dict,
    is_best: bool,
    best_name: str = "best_loss",
    extra_best: dict[str, bool] | None = None,
) -> str:
    """The reference's cadence: always write ``latest``, copy it to
    ``best_<metric>`` when the validation metric improved; ``extra_best``
    maps more slot names to their improvement flags."""
    os.makedirs(ckpt_dir, exist_ok=True)
    latest = os.path.join(ckpt_dir, "latest.npz")
    save(latest, tree, ckpt_info)

    def copy_to(name: str) -> None:
        best = os.path.join(ckpt_dir, f"{name}.npz")
        shutil.copyfile(latest, best)
        info = _info_path(latest)
        if os.path.exists(info):
            shutil.copyfile(info, _info_path(best))

    if is_best:
        copy_to(best_name)
    for name, flag in (extra_best or {}).items():
        if flag:
            copy_to(name)
    return latest
