"""Tools of the port: the integer-unit microbenchmark (profile_alu), the
G2 point-kernel check against zkrollup_torch.ref (g2_kernel_check) and
the kernels' build time as one nvcc unit (build_time)."""
