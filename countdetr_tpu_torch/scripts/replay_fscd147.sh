#!/usr/bin/env bash
# The reference's full FSCD-147 two-stage schedule as one command, through
# the port's CLI: stage-1 train -> pseudo-label generation -> stage-2 train
# -> inference -> offline evaluation, with the reference presets
# (weakly_supervise_fscd_147.sh: stage 1, defined prior, 30 epochs;
# var_wh_laplace_600.sh: stage 2, grid prior, 600 queries, 1200 epochs at
# batch 1 -> here batch 8 with a linearly scaled lr, or EXACT_REPLAY=1 for
# batch 1 and scipy's exact matcher on the host).
#
# Usage, from anywhere:
#   bash countdetr_tpu_torch/scripts/replay_fscd147.sh                  # synthetic dry run
#   DATA_PATH=/data/FSC147 bash countdetr_tpu_torch/scripts/replay_fscd147.sh
#   EXACT_REPLAY=1 DATA_PATH=... bash countdetr_tpu_torch/scripts/replay_fscd147.sh
#   SMOKE=1 DATA_PATH=... bash countdetr_tpu_torch/scripts/replay_fscd147.sh
#     ~50 train steps of each stage at production geometry, then the whole
#     pseudo-label / inference / evaluation chain
# DEVICE (default cuda) is passed to --device; DTYPE (default bfloat16 on
# cuda, float32 on cpu) to --compute_dtype; OUT (default $TMPDIR or /tmp,
# countdetr_torch_replay) holds the runs.
#
# Without DATA_PATH it writes a synthetic FSC-147 tree without pseudo labels
# (data/synthetic.py) and runs the five steps on it at tiny width, a few
# epochs each. With DATA_PATH it prints the expected wall time first, from
# the port's stage-1 and stage-2 training rates measured on the card.
set -e
cd "$(dirname "$0")/../.."

DEVICE="${DEVICE:-cuda}"
if [ "${DEVICE}" = "cpu" ]; then DTYPE="${DTYPE:-float32}"; else DTYPE="${DTYPE:-bfloat16}"; fi
TMP="${TMPDIR:-/tmp}"
OUT="${OUT:-${TMP}/countdetr_torch_replay}"
SYNTH=0
if [ -z "${DATA_PATH}" ]; then
  SYNTH=1
  DATA_PATH="${TMP}/countdetr_torch_replay_data"
  echo "== no DATA_PATH: dry-running on a synthetic FSCD-147 tree =="
  python3 -c "from countdetr_tpu_torch.data.synthetic import make_synthetic_fscd147 as m; m('${DATA_PATH}', n_train=8, n_val=3, n_test=3, size=(96, 128), with_pseudo=False)"
  S1_EPOCHS="${S1_EPOCHS:-2}";  S2_EPOCHS="${S2_EPOCHS:-2}"
  SIZE_FLAGS="--buckets 96x128 --max_points 32 --max_boxes 64 --batch_size 3"
  MODEL_FLAGS="--enc_layers 1 --dec_layers 1 --hidden_dim 32 --nheads 4 --dim_feedforward 64"
  Q1="--num_query_position 3"; Q2="--num_query_position 25"
  LR1="--lr 2e-3"; LR2="--lr 1e-3"
else
  S1_EPOCHS="${S1_EPOCHS:-30}"; S2_EPOCHS="${S2_EPOCHS:-1200}"
  SIZE_FLAGS="--buckets 384x384,384x512,384x672 --max_points 700 --max_boxes 700"
  MODEL_FLAGS=""
  Q1="--num_query_position 3"; Q2="--num_query_position 600"
  if [ "${SMOKE}" = "1" ]; then
    SIZE_FLAGS="$SIZE_FLAGS --max_steps ${SMOKE_STEPS:-50}"
    S1_EPOCHS=1; S2_EPOCHS=1
    echo "== SMOKE mode: ${SMOKE_STEPS:-50} train steps per stage =="
  fi
  if [ "${EXACT_REPLAY}" = "1" ]; then
    SIZE_FLAGS="$SIZE_FLAGS --exact_replay"
    LR1="--lr 1e-4"; LR2="--lr 1e-4"
  else
    # batch 8 with the lr scaled linearly from the reference's 1e-4 at batch 1
    SIZE_FLAGS="$SIZE_FLAGS --batch_size 8"
    LR1="--lr 8e-4"; LR2="--lr 8e-4"
  fi
  python3 - <<PY
import json, os, subprocess
n_train = len(json.load(open(os.path.join("${DATA_PATH}", "Train_Test_Val_FSC_147.json")))["train"])
# the CLI's training epochs at full width, B=8, bf16, each a fresh worker
# pool, on a synthetic tree of 384x576 FSC-147-like images (chip_smoke.py
# phase cli: stage 1 train_img_per_s under rank-1, stage 2 over its two
# epochs; PERF.md section 5)
card = "NVIDIA H100 80GB HBM3, 700.00 W"
s1_ips, s2_ips = 11.35, 20.57
s1 = n_train * ${S1_EPOCHS} / s1_ips / 3600
s2 = n_train * ${S2_EPOCHS} / s2_ips / 3600
try:
    here = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip() or "no card"
except OSError:
    here = "no nvidia-smi"
print(f"== expected wall time at {s1_ips} / {s2_ips} img/s (stage 1 / 2, measured on {card}): "
      f"stage1 ~{s1:.1f} h, stage2 ~{s2:.1f} h; this machine: {here} ==")
PY
fi

COMMON="--dataset_file fscd_147 --data_path ${DATA_PATH} ${SIZE_FLAGS} ${MODEL_FLAGS} --num_workers ${NUM_WORKERS:-4} --decoded_cache --device ${DEVICE} --compute_dtype ${DTYPE}"
CLI="python3 -m countdetr_tpu_torch.cli.main"

echo "== [1/5] stage-1 train (${S1_EPOCHS} epochs) =="
${CLI} --stage 1 ${COMMON} ${Q1} ${LR1} \
  --spatial_prior defined --num_query_pattern 1 \
  --output_dir "${OUT}/stage1" --epochs "${S1_EPOCHS}" --auto_resume

echo "== [2/5] pseudo-label generation =="
${CLI} --stage 1 ${COMMON} ${Q1} \
  --spatial_prior defined --num_query_pattern 1 \
  --output_dir "${DATA_PATH}/annotations" --generate_pseudo_label \
  --resume "${OUT}/stage1/checkpoints"

echo "== [3/5] stage-2 train (${S2_EPOCHS} epochs, var_wh_laplace_600 preset) =="
${CLI} --stage 2 ${COMMON} ${Q2} ${LR2} \
  --spatial_prior grid --num_query_pattern 1 --no_aux_loss \
  --output_dir "${OUT}/stage2" --epochs "${S2_EPOCHS}" --auto_resume

echo "== [4/5] inference (val + test) =="
${CLI} --stage 2 ${COMMON} ${Q2} \
  --spatial_prior grid --num_query_pattern 1 --no_aux_loss \
  --output_dir "${OUT}/stage2" --infer \
  --checkpoint_path "${OUT}/stage2/checkpoints"

echo "== [5/5] offline evaluation =="
${CLI} --stage 2 --dataset_file fscd_147 \
  --data_path "${DATA_PATH}" --output_dir "${OUT}/stage2" \
  --evaluate_predictions "${OUT}/stage2/predictions_test.json"

echo "== REPLAY PIPELINE COMPLETE (out: ${OUT}) =="
if [ "$SYNTH" = "1" ]; then echo "(synthetic dry run; set DATA_PATH for the real schedule)"; fi
