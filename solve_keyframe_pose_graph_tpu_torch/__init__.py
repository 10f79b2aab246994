"""PyTorch + CUDA port of the keyframe pose-graph back-end.

The JAX package ``solve_keyframe_pose_graph_tpu`` beside this one is the
reference: every module here mirrors the file of the same path there and is
held against it by parity tests (tests/test_torch_*.py). This package imports
``torch`` and never ``jax``. It reuses the reference package's numpy-only
host modules (config, graph store and worlds, synthetic graphs, numpy SE(3),
timing), which import no jax either.

The two Pallas TPU kernels of the reference are hand-written CUDA C++ for
Hopper (sm_90a) under ``csrc/``, built with nvcc at first use
(ops/_kernels.py): ops/band_matvec.py (the odometry-band matvec of every CG
iteration) and ops/smallinv.py (the batched SPD inverses of the band
factorization).
"""

__version__ = "0.1.0"
