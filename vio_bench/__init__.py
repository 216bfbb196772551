"""The benchmark of the PyTorch and CUDA port (``ode_vio_tpu_torch``):
served windows, whole-sequence evaluation and training on one H100.
Entry point: ``python -m vio_bench.run`` (``vio_bench/harness.py``)."""
