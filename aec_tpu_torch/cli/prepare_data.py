"""Data preparation CLI: wav quadruples -> h5 ``.ex`` files and their lists,
with the splits, file names, lists and dataset names of
``aec_tpu/cli/prepare_data.py``:

  python -m aec_tpu_torch.cli.prepare_data train --wav_path ... --h5_path ... --list_path ...
  python -m aec_tpu_torch.cli.prepare_data test  --wav_path ... --h5_path ... --list_path ...
  python -m aec_tpu_torch.cli.prepare_data val   --wav_path ... --h5_path ... --list_path ...

train: one ``tr_<id>.ex`` per utterance and ``tr_list.txt``;
test:  grouped ``test.ex``, ``tt_list.txt`` and ``filename.txt``;
val:   grouped ``test2.ex`` with mic/ref/near/echo names and ``tt_list2.txt``.

Host work only (numpy, scipy and h5py): no device is touched.
"""

from __future__ import annotations

import argparse
import os

from aec_tpu_torch.pipeline import h5io

# the val packer's dataset names for the train layout's roles
_VAL_NAMES = {"mic": "nearend_mic", "ref": "farend_speech", "near": "nearend_speech",
              "echo": "echo"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="wav -> h5 .ex packer")
    p.add_argument("split", choices=("train", "test", "val"))
    p.add_argument("--wav_path", required=True)
    p.add_argument("--h5_path", required=True)
    p.add_argument("--list_path", required=True)
    p.add_argument("--sr", type=int, default=16000)
    args = p.parse_args(argv)

    os.makedirs(args.h5_path, exist_ok=True)
    os.makedirs(args.list_path, exist_ok=True)

    if args.split == "train":
        entries = h5io.pack_train_dir(args.wav_path, args.h5_path,
                                      os.path.join(args.list_path, "tr_list.txt"), args.sr)
        print(f"wrote {len(entries)} train .ex files")
        return

    quads = list(h5io.iter_wav_quads(args.wav_path, args.sr))
    if args.split == "test":
        out = os.path.join(args.h5_path, "test.ex")
        h5io.write_grouped(out, (u for _, u in quads), keys=h5io.TRAIN_KEYS)
        h5io.write_filelist(os.path.join(args.list_path, "tt_list.txt"), [out])
        h5io.write_filelist(os.path.join(args.list_path, "filename.txt"),
                            [fid for fid, _ in quads])
    else:
        out = os.path.join(args.h5_path, "test2.ex")
        h5io.write_grouped(out, ({k: u[v] for k, v in _VAL_NAMES.items()} for _, u in quads),
                           keys=h5io.VAL_KEYS)
        h5io.write_filelist(os.path.join(args.list_path, "tt_list2.txt"), [out])
    print(f"wrote {len(quads)} utterances to {out}")


if __name__ == "__main__":
    main()
