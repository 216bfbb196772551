"""Data layer: KITTI odometry loading, irregular-sampling injection,
windowing, transforms, the native decode runtime, the synthetic
mini-KITTI fixture and the evaluation-side streaming partitioner."""
