"""Segment-splitting streaming loader (``aec_tpu/pipeline/segment_loader.py``;
reference: utils/data_utils.py).

The reference carries a complete fixed-segment loading stack that only its
broken FullSubNet driver consumed (SURVEY §2.3): per-utterance max-abs
normalization (data_utils.py:67-71), 4 s / 1 s-shift segmentation
(``SegSplitter``, data_utils.py:81-111), and a buffered batcher
(``AudioLoader``, data_utils.py:114-204). It trains on long audio with
fixed shapes: every batch has the same shape (seg_len). Plain numpy
iterators over the h5 ``.ex`` formats, the JAX package's copy: the same
segments, the same shuffle stream, the same batches in the same order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from aec_tpu_torch.pipeline import h5io

KEYS = ("mic", "ref", "near", "echo")
_TRAIN_TO_SEG = {
    "mic": "nearend_mic",
    "ref": "farend_speech",
    "near": "nearend_speech",
    "echo": "echo",
}


def normalize_utt(utt: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Per-channel max-abs normalization (data_utils.py:67-71 semantics —
    note the reference divides by max(abs) with no epsilon)."""
    return {k: v / np.max(np.abs(v)) for k, v in utt.items()}


def split_segments(
    utt: dict[str, np.ndarray], seg_len: int, hop_len: int
) -> list[dict[str, np.ndarray]]:
    """Fixed-length segments with shift (SegSplitter, data_utils.py:85-111):
    shorter utterances are zero-padded to one segment (true length kept in
    ``n_samples``); the trailing partial segment is dropped."""
    n = len(utt[KEYS[0]])
    if n < seg_len:
        seg = {k: np.pad(v, (0, seg_len - n)) for k, v in utt.items()}
        seg["n_samples"] = n
        return [seg]
    segs = []
    start = 0
    while start + seg_len <= n:
        seg = {k: v[start : start + seg_len] for k, v in utt.items()}
        seg["n_samples"] = seg_len
        segs.append(seg)
        start += hop_len
    return segs


class SegmentLoader:
    """Iterate fixed-shape [batch, seg_len] batches from .ex files.

    ``files``: list of per-utterance .ex paths (train layout) or a single
    grouped file path (val layout). Matches AudioLoader's contract with
    static shapes; partial tail batches are dropped in 'train' mode.
    """

    def __init__(
        self,
        files: list[str] | str,
        *,
        segment_size: float = 4.0,
        segment_shift: float = 1.0,
        sample_rate: int = 16000,
        batch_size: int = 4,
        in_norm: bool = True,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.files = files
        self.seg_len = int(segment_size * sample_rate)
        self.hop_len = int(segment_shift * sample_rate)
        self.batch_size = batch_size
        self.in_norm = in_norm
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def _utts(self) -> Iterator[dict[str, np.ndarray]]:
        if isinstance(self.files, str):  # grouped val layout (mic/ref/near/echo)
            order = np.arange(h5io.group_count(self.files))
            if self.shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield h5io.read_group(self.files, int(i), keys=h5io.VAL_KEYS)
        else:
            order = np.arange(len(self.files))
            if self.shuffle:
                self.rng.shuffle(order)
            for i in order:
                raw = h5io.read_utterance(self.files[int(i)])
                yield {k: raw[v] for k, v in _TRAIN_TO_SEG.items()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        pending: list[dict] = []
        for utt in self._utts():
            if self.in_norm:
                utt = normalize_utt(utt)
            pending.extend(split_segments(utt, self.seg_len, self.hop_len))
            while len(pending) >= self.batch_size:
                batch, pending = pending[: self.batch_size], pending[self.batch_size :]
                yield self._stack(batch)

    def _stack(self, segs: list[dict]) -> dict[str, np.ndarray]:
        out = {
            k: np.stack([s[k] for s in segs]).astype(np.float32) for k in KEYS
        }
        out["n_samples"] = np.asarray([s["n_samples"] for s in segs], dtype=np.int64)
        return out
