"""The lower-bound (psum-stationary) matmul: op, CUDA kernel (K3) and
its plain version."""
