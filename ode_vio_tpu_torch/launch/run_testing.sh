#!/usr/bin/env bash
# Evaluation sweeps under input irregularity on the PyTorch port: the flag
# sets of the JAX package's scripts/run_testing.sh (eval frame dropout in
# {0, 0.3, 0.5, 0.7}, 10 repeats), for python -m ode_vio_tpu_torch.cli.
# CKPT is a checkpoints directory that cli.train wrote (its latest epoch,
# else best) or a reference-layout .pth. Run from the repository's root.
set -euo pipefail

DATA_DIR=${DATA_DIR:-./dataset}
CKPT=${CKPT:-./results/ode_vio/checkpoints}

for DROP in 0.0 0.3 0.5 0.7; do
  python -m ode_vio_tpu_torch.cli.test \
    --data_dir "$DATA_DIR" \
    --experiment_name "ode_vio_drop${DROP}" \
    --model_type ode-rnn --fuse_method soft \
    --ode_activation_fn softplus --ode_fn_num_layers 2 \
    --ode_hidden_dim 1024 --rnn_num_layers 3 \
    --pretrain "$CKPT" \
    --eval_data_dropout "$DROP" \
    --run_times 10 \
    "$@"
done

# Online serving latency check on the canonical config (one sequence,
# carried state, p50/p90/p99 window latency as one JSON line).
python -m ode_vio_tpu_torch.cli.serve \
  --data_dir "$DATA_DIR" \
  --experiment_name "ode_vio_serve" \
  --model_type ode-rnn --fuse_method soft \
  --ode_activation_fn softplus --ode_fn_num_layers 2 \
  --ode_hidden_dim 1024 --rnn_num_layers 3 \
  --pretrain "$CKPT" \
  --val_seq 05 \
  "$@"
