#!/usr/bin/env bash
# Training entry point of the PyTorch port (aec_tpu_torch.cli.train): the
# flags and environment variables of run_train.sh, plus DEVICE (cuda by
# default; cpu for a run without the card).
set -euo pipefail

CKPT_DIR=${CKPT_DIR:-exp}
TR_LIST=${TR_LIST:-examples/filelists/tr_list.txt}
CV_FILE=${CV_FILE:-examples/h5/cv.ex}
DEVICE=${DEVICE:-cuda}

python -m aec_tpu_torch.cli.train \
  --tr_list "$TR_LIST" \
  --cv_file "$CV_FILE" \
  --ckpt_dir "$CKPT_DIR" \
  --device "$DEVICE" \
  "$@"
