"""Host-side utilities: geometry and KITTI metrics primitives, experiment
directories and loggers."""
