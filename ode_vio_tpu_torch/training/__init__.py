"""The training step and the inference callables."""
