// The G2 point kernels (over Fq2): g2_add, g2_madd_nd, g2_madd,
// g2_double, g2_add_z01 and g2_add_nd on the paired Fq2 type, two threads
// a lane (jac_add_pair_kernel, jac_madd_nd_pair_kernel,
// jac_madd_pair_kernel, jac_double_pair_kernel, jac_add_z01_pair_kernel,
// jac_add_nd_pair_kernel), and the MSM's Horner on it (g2_horner_kernel,
// one warp). Built by its own nvcc, beside g1.cu, fields.cu and alu.cu.
//
// The paired kernels' launch bounds (PAIR_THREADS, PAIR_MIN_BLOCKS in
// points.cuh) are set from ptxas -v for sm_90a (chip_smoke.py phase 1): no
// spill, and more resident warps an SM than the one-thread kernels' 8.
// Each of the SM's four sub-partitions holds 16K registers, so the cap
// falls in steps: 255 registers a thread for 8 warps, 168 for 12, 128 for
// 16. At (128, 3), 12 warps, jac_add_pair_kernel and jac_madd_pair_kernel
// take 168 registers and jac_madd_nd_pair_kernel 150, with no spill and no
// stack frame; at (128, 4) all three spill (120, 80 and 24 bytes). The
// one-thread jac_add<Fq2> took 255 and spilled 172 bytes, jac_madd_nd<Fq2>
// 255 and 16, jac_madd<Fq2> 255 and 20. chip_smoke.py phase 1 fails if a
// paired kernel spills. The double went onto thread pairs next: one
// thread computing it over Fq2 took 137 registers. The z01 add
// (g2_add_z01, held at 22 windows x 2^16 lanes) went last: over Fq2 on
// one thread it took 255 registers and spilled 60 bytes; on pairs
// (jac_add_z01_pair_kernel) it takes 168 at (128, 3) with no spill, its
// doubling path voted per 16-lane warp (jac_add_z01_voted_lane).
// The add without the doubling path (g2_add_nd, 44 Fq products a lane)
// went onto pairs after it: over Fq2 on one thread, jac_add_nd<Fq2>, it
// took 255 registers and spilled 60 bytes. jac_add_nd_pair_kernel runs
// the same lane (curve.cuh:jac_add_nd_lane) with the Fq2 product called,
// as the other paired kernels, at (PAIR_THREADS, PAIR_MIN_BLOCKS); it
// keeps the distinct contract: where H = 0 with neither operand infinite
// (P + (-P), and P + P, outside the contract) the result has Z = 0.
#include "points.cuh"

namespace zkt {
ZKT_PAIR_KERNEL(jac_add_pair_kernel, jac_add_lane)
ZKT_PAIR_KERNEL(jac_madd_nd_pair_kernel, jac_madd_nd_lane)
ZKT_PAIR_KERNEL(jac_madd_pair_kernel, jac_madd_lane)
ZKT_PAIR_KERNEL(jac_double_pair_kernel, jac_double_lane)
ZKT_PAIR_KERNEL(jac_add_z01_pair_kernel, jac_add_z01_voted_lane)
ZKT_PAIR_KERNEL(jac_add_nd_pair_kernel, jac_add_nd_lane)
ZKT_HORNER_KERNEL(g2_horner_kernel, Fq2Pair, 2)
}  // namespace zkt

ZKT_POINT_API(g2, add, zkt::launch_pair, zkt::jac_add_pair_kernel, 2)
ZKT_POINT_API(g2, madd_nd, zkt::launch_pair, zkt::jac_madd_nd_pair_kernel, 2)
ZKT_POINT_API(g2, add_nd, zkt::launch_pair, zkt::jac_add_nd_pair_kernel, 2)
ZKT_POINT_API(g2, add_z01, zkt::launch_pair, zkt::jac_add_z01_pair_kernel, 2)
ZKT_POINT_API(g2, madd, zkt::launch_pair, zkt::jac_madd_pair_kernel, 2)
ZKT_POINT_API(g2, double, zkt::launch_pair, zkt::jac_double_pair_kernel, 1)
ZKT_HORNER_API(g2, zkt::Fq2Pair, zkt::g2_horner_kernel)
