"""PyTorch + CUDA port of the keyframe pose-graph back-end.

The JAX package ``solve_keyframe_pose_graph_tpu`` beside this one is the
reference: every module here mirrors the file of the same path there and is
held against it by parity tests (tests/test_torch_*.py). This package imports
``torch``, numpy, the standard library and itself: nothing of ``jax`` and
nothing of the JAX package. Its host modules (config, graph store and worlds,
native store binding, g2o I/O, synthetic graphs, numpy SE(3), logging,
timing, the native LDL^T binding) are its own copies of the JAX package's
numpy-only ones.

The library entry points (SolverEngine, PoseGraphServer, build_problem_np)
and the CLI run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA the default raises.

The two Pallas TPU kernels of the reference are hand-written CUDA C++ for
Hopper (sm_90a) under ``csrc/``, built with nvcc at first use
(ops/_kernels.py): ops/band_matvec.py (the odometry-band matvec of every CG
iteration) and ops/smallinv.py (the batched SPD inverses of the band
factorization).
"""

__version__ = "0.1.0"
