"""Tensor-level operations: MLPs, RNN cells, the solver core and the
CUDA kernels."""
