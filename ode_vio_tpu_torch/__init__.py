"""ODE-VIO in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``ode_vio_tpu``: same subpackages and module
names, same configuration fields and the reference checkpoint layout.
It imports nothing of the JAX package. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
