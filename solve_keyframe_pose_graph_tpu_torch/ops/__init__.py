"""Device-side math in PyTorch: SE(3), residual block products, Gauss-Newton
assembly, PCG, preconditioners, LM, and the two CUDA kernels."""
