"""Command lines: streaming KITTI evaluation (test), online serving
(serve) and trajectory plots (plot)."""
