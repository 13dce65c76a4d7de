#!/usr/bin/env bash
# Evaluation entry point of the PyTorch port: enhancement by
# aec_tpu_torch.cli.infer (TEST_STEP), then metrics by
# aec_tpu_torch.cli.measure (EVAL_STEP), with the flags and environment
# variables of run_evaluate.sh, plus DEVICE for the enhancement (cuda by
# default; cpu for a run without the card).
set -euo pipefail

TEST_STEP=${TEST_STEP:-1}
EVAL_STEP=${EVAL_STEP:-1}
CKPT_DIR=${CKPT_DIR:-exp}
TT_LIST=${TT_LIST:-examples/filelists/tt_list.txt}
MODEL_FILE=${MODEL_FILE:-$CKPT_DIR/models/best_loss.npz}
EST_PATH=${EST_PATH:-estimates}
DEVICE=${DEVICE:-cuda}

if [ "$TEST_STEP" = "1" ]; then
  python -m aec_tpu_torch.cli.infer \
    --tt_list "$TT_LIST" \
    --ckpt_dir "$CKPT_DIR" \
    --model_file "$MODEL_FILE" \
    --est_path "$EST_PATH" \
    --device "$DEVICE" \
    "$@"
fi

if [ "$EVAL_STEP" = "1" ]; then
  # METRICS defaults to the reference's working set; add pesq (external
  # impl preferred; set PESQ_APPROX=1 to allow the bundled from-spec model)
  METRICS=${METRICS:-stoi,sisnr,erle,snr}
  EXTRA=()
  if [ "${PESQ_APPROX:-0}" = "1" ]; then EXTRA+=(--allow-approx-pesq); fi
  for d in "$EST_PATH"/*/; do
    python -m aec_tpu_torch.cli.measure --est_dir "$d" --metrics "$METRICS" \
      --json_out "$d/metrics.json" "${EXTRA[@]}"
  done
fi
