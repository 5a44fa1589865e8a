"""The lower-bound (psum-stationary) matmul: op, CUDA kernels (K3: bf16
on the tensor cores, and FMA) and their plain version."""
