"""Multi-session streaming inference."""

from ode_vio_tpu_torch.serving.engine import StreamingEngine  # noqa: F401
