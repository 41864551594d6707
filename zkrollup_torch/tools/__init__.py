"""Tools of the port: the integer-unit microbenchmark (profile_alu), the
G2 point-kernel check against zkrollup_torch.ref (g2_kernel_check), the
kernels' build time as one nvcc unit (build_time), two processes over the
loopback (multihost_sim), and the counterparts of the reference's
measurement tools: a profiled proof by stage label (trace_prove), the
prover's stages one by one (prove_breakdown), the MSM's stages
(profile_msm), distinct points and the fused four tables (profile_msm2),
window c by scan chunk (msm_sweep), the MSM's building blocks
(profile_kernels) and the mesh prover against one device
(mesh_prove_check); the profiler's dropped first device events
(profiler_drops); what they share is in common."""
