"""Learning experiments on the port: the JAX repository's convergence
checks (``convergence.py``) and its irregular-sampling experiment
(``irregularity.py``), on synthetic KITTI trees the port writes itself."""
