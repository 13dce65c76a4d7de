"""HDF5 ``.ex`` dataset I/O, byte-compatible with the reference's schemas
(``aec_tpu/pipeline/h5io.py``).

Three layouts exist in the reference's packers (all float32):

- TRAIN: one ``.ex`` file per utterance holding four root datasets
  ``nearend_speech / nearend_mic / farend_speech / echo``, listed in
  ``tr_list.txt``;
- TEST: one ``.ex`` file with numbered groups "0".."N-1", each holding the
  same four dataset names;
- VAL: grouped like TEST but datasets named ``mic / ref / near / echo``.

``h5py`` is imported inside the functions: the package imports without it
(a machine that only runs inference needs none).
"""

from __future__ import annotations

import glob
import os
from typing import Iterable, Mapping

import numpy as np

from aec_tpu_torch.pipeline.audio_io import read_wav

TRAIN_KEYS = ("nearend_speech", "nearend_mic", "farend_speech", "echo")
VAL_KEYS = ("mic", "ref", "near", "echo")


def write_utterance(path: str, utt: Mapping[str, np.ndarray]) -> None:
    """TRAIN layout: four root datasets in one file."""
    import h5py

    with h5py.File(path, "w") as f:
        for key in TRAIN_KEYS:
            data = np.asarray(utt[key], dtype=np.float32)
            f.create_dataset(key, data=data, shape=data.shape, chunks=True)


def read_utterance(path: str) -> dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k], dtype=np.float32) for k in TRAIN_KEYS}


def utterance_length(path: str) -> int:
    """Sample count of a TRAIN-layout file, from h5 metadata (no data read)."""
    import h5py

    with h5py.File(path, "r") as f:
        return int(f[TRAIN_KEYS[0]].shape[0])


def write_grouped(
    path: str, utts: Iterable[Mapping[str, np.ndarray]], keys=TRAIN_KEYS
) -> int:
    """TEST/VAL layout: numbered groups "0".."N-1" (``keys=VAL_KEYS`` for
    the val packer's naming). Returns the number of groups written."""
    import h5py

    n = 0
    with h5py.File(path, "w") as f:
        for i, utt in enumerate(utts):
            grp = f.create_group(str(i))
            for key in keys:
                data = np.asarray(utt[key], dtype=np.float32)
                grp.create_dataset(key, data=data, shape=data.shape, chunks=True)
            n += 1
    return n


def read_group(path: str, index: int, keys=TRAIN_KEYS) -> dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        grp = f[str(index)]
        return {k: np.asarray(grp[k], dtype=np.float32) for k in keys}


def group_count(path: str) -> int:
    import h5py

    with h5py.File(path, "r") as f:
        return len(f)


def write_filelist(path: str, entries: list[str]) -> None:
    """Newline-joined list file (the reference's tr_list.txt format)."""
    with open(path, "w") as f:
        f.write("\n".join(entries))


def read_filelist(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def iter_wav_quads(wav_dir: str, sr: int = 16000):
    """``(file id, utterance)`` for each ``nearend_speech_fileid_<id>.wav``
    of ``wav_dir`` in sorted order: the aligned quadruple read at ``sr``
    (the reference packers' input layout)."""
    for near_path in sorted(glob.glob(os.path.join(wav_dir, "nearend_speech_fileid_*.wav"))):
        fid = os.path.basename(near_path).rsplit(".wav", 1)[0].rsplit("_", 1)[-1]
        yield fid, {key: read_wav(os.path.join(wav_dir, f"{key}_fileid_{fid}.wav"), sr)[0]
                    for key in TRAIN_KEYS}


def pack_train_dir(wav_dir: str, h5_dir: str, list_path: str, sr: int = 16000) -> list[str]:
    """The reference's train packer: one ``tr_<id>.ex`` per wav quadruple
    of ``wav_dir`` under ``h5_dir/tr``, and the list of them at
    ``list_path``."""
    out_dir = os.path.join(h5_dir, "tr")
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for fid, utt in iter_wav_quads(wav_dir, sr):
        ex_path = os.path.join(out_dir, f"tr_{fid}.ex")
        write_utterance(ex_path, utt)
        entries.append(ex_path)
    os.makedirs(os.path.dirname(list_path) or ".", exist_ok=True)
    write_filelist(list_path, entries)
    return entries
