#!/usr/bin/env bash
# Canonical training launches of the PyTorch port: the flag sets of the
# JAX package's scripts/run_training.sh, for python -m ode_vio_tpu_torch.cli.
# They run on the card (--device cuda, the default); --use_kernels is the
# port's name for --use_pallas. Run from the repository's root.
set -euo pipefail

DATA_DIR=${DATA_DIR:-./dataset}

# --- ODE-VIO flagship (ODE-RNN; the reference's canonical config) -----------
# Add --frozen_encoder_eval for the fast recipe: the frozen FlowNet runs its
# inference graph inside the train step (BN folded, trunk dropout off). Off
# here for exact reference train-mode semantics.
python -m ode_vio_tpu_torch.cli.train \
  --data_dir "$DATA_DIR" \
  --experiment_name ode_vio \
  --model_type ode-rnn \
  --fuse_method soft \
  --ode_activation_fn softplus \
  --ode_fn_num_layers 2 \
  --ode_hidden_dim 1024 \
  --rnn_num_layers 3 \
  --freeze_encoder \
  --data_dropout 0.3 --data_dropout_std 0.1 \
  --eval_data_dropout 0.3 \
  --batch_size 16 \
  --pretrain_flownet "${FLOWNET:-./pretrained_models/flownets_bn_EPE2.459.pth.tar}" \
  "$@"

# --- Discrete RNN baseline ---------------------------------------------------
# python -m ode_vio_tpu_torch.cli.train --data_dir "$DATA_DIR" \
#   --experiment_name rnn_baseline --model_type rnn --fuse_method soft \
#   --rnn_num_layers 3 --freeze_encoder --data_dropout 0.3 --data_dropout_std 0.1

# --- Neural CDE ---------------------------------------------------------------
# python -m ode_vio_tpu_torch.cli.train --data_dir "$DATA_DIR" \
#   --experiment_name cde --model_type cde --fuse_method soft \
#   --cde_hidden_dim 128 --cde_solver dopri5 --freeze_encoder \
#   --data_dropout 0.3 --data_dropout_std 0.1

# --- Neural RDE (log-signature windows) ----------------------------------------
# python -m ode_vio_tpu_torch.cli.train --data_dir "$DATA_DIR" \
#   --experiment_name rde --model_type rde --fuse_method soft --freeze_encoder
