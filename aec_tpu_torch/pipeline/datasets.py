"""Batching / loading for training and evaluation
(``aec_tpu/pipeline/datasets.py``).

Zero-pad to the batch max like the reference, then round the padded length
up to a bucket quantum, so the device sees few distinct shapes. A background
thread prefetches h5 reads. The shuffle draws from
``np.random.default_rng(seed)`` exactly as the JAX loader does, so the port
and the JAX package see the same batches in the same order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from aec_tpu_torch.pipeline import h5io

BATCH_KEYS = ("nearend_speech", "nearend_mic", "farend_speech", "echo")


def collate(
    utts: list[dict[str, np.ndarray]], bucket_quantum: int = 0, pad_to: int = 0
) -> dict[str, np.ndarray | int]:
    """Zero-pad each key to the batch max length and stack.

    ``n_samples`` carries the true max length for frame-weighted loss
    accounting. ``bucket_quantum > 0`` additionally pads up to a multiple
    (trailing zeros); ``pad_to > 0`` pads to that exact length.
    """
    max_len = max(len(u[BATCH_KEYS[0]]) for u in utts)
    n_samples = max_len
    if pad_to:
        if max_len > pad_to:
            raise ValueError(f"utterance length {max_len} exceeds pad_to={pad_to}")
        max_len = pad_to
    elif bucket_quantum:
        max_len = -(-max_len // bucket_quantum) * bucket_quantum
    out: dict[str, np.ndarray | int] = {}
    for key in BATCH_KEYS:
        batch = np.zeros((len(utts), max_len), dtype=np.float32)
        for i, u in enumerate(utts):
            x = u[key]
            batch[i, : len(x)] = x
        out[key] = batch
    out["n_samples"] = n_samples
    return out


class TrainLoader:
    """Shuffled epoch iterator over per-utterance ``.ex`` files:
    DataLoader(batch_size, shuffle=True, drop_last=True) semantics with a
    background prefetch thread instead of worker processes."""

    def __init__(
        self,
        file_list: list[str],
        batch_size: int,
        *,
        bucket_quantum: int = 4096,
        pad_to: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.file_list = list(file_list)
        self.batch_size = batch_size
        self.bucket_quantum = bucket_quantum
        self.pad_to = pad_to
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.file_list) // self.batch_size
        if not self.drop_last and len(self.file_list) % self.batch_size:
            n += 1
        return n

    def _batches(self) -> Iterator[dict]:
        order = np.arange(len(self.file_list))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % self.batch_size if self.drop_last else 0)
        for lo in range(0, stop, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            utts = [h5io.read_utterance(self.file_list[i]) for i in idx]
            yield collate(utts, self.bucket_quantum, self.pad_to)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure: list[BaseException] = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as exc:  # handed to the consumer, raised there
                failure.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]


class EvalLoader:
    """Sequential iterator over a grouped ``.ex`` file; ``batch_size=1`` is
    the reference's eval cadence, larger batches collate like training."""

    def __init__(
        self,
        path: str,
        batch_size: int = 1,
        *,
        keys=h5io.TRAIN_KEYS,
        bucket_quantum: int = 0,
    ):
        self.path = path
        self.batch_size = batch_size
        self.keys = keys
        self.bucket_quantum = bucket_quantum
        self.n = h5io.group_count(path)

    def __len__(self) -> int:
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        for lo in range(0, self.n, self.batch_size):
            utts = []
            for i in range(lo, min(lo + self.batch_size, self.n)):
                u = h5io.read_group(self.path, i, keys=self.keys)
                if self.keys != h5io.TRAIN_KEYS:
                    u = dict(zip(h5io.TRAIN_KEYS, (u["near"], u["mic"], u["ref"], u["echo"])))
                utts.append(u)
            yield collate(utts, self.bucket_quantum)
