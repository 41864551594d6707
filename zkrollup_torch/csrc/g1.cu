// The G1 point kernels: g1_add, g1_madd_nd, g1_madd, g1_add_z01 and
// g1_add_nd over FqCall (fq_call.cuh, the product called rather than
// inlined; g1_add_kernel, g1_madd_nd_kernel, g1_madd_kernel,
// g1_add_z01_kernel, g1_add_nd_kernel), g1_double (the template of
// points.cuh) and the MSM's Horner (g1_horner_kernel) over G1Dbl, FqCall
// too. Built by its own nvcc, beside g2.cu, fields.cu and alu.cu.
//
// g1_add and g1_madd_nd carry the G1 MSM of a proof: g1_madd_nd runs 127
// launches of 74,492 lanes (the scan leg, 22 windows x 3,386 chunks),
// g1_add 38 launches of 360,448 lanes and fewer. g1_add runs the doubling
// path only in warps where a lane needs it (jac_add_lane's vote); on the
// (2,6) proof's own operands no lane of its 38 launches does
// (chip_smoke.py phase 4). g1_madd carries the setup's fixed-base steps:
// 32 launches of the (2,6) key's 482,413 lanes (msm/fixed_base.py), where
// no lane needs its doubling path either (curve.cuh:jac_madd_lane), and
// the MSM's scan leg on the msm paths (distinct=False).
//
// Launch bounds from ptxas -v for sm_90a (chip_smoke.py phase 1 fails if
// a kernel spills or needs more registers than its bound leaves): over
// FqCall g1_add takes 149 registers (12 warps an SM), g1_madd_nd 124 (16)
// and g1_madd 139 (12), no spill. Fewer registers cost more than the
// occupancy they buy: at (128, 4) g1_add spills 48 bytes and g1_madd 24,
// and at (128, 5), the bound that would hold 74,492 lanes in one wave of
// 20 warps, g1_madd_nd spills 192; each ran slower than at these bounds
// (g1_madd 4% at 482,413 lanes, chip_smoke.py --ab).
//
// g1_add_z01 adds two points with Z in {0, 1} (JacobianCurve.add_z01),
// held at 22 windows x 2^16 lanes, 1,441,792 a launch. Over Fq, one
// thread a lane with both paths computed on every lane, it ran 6 + 6
// products a lane; over FqCall with the doubling path voted
// per warp (curve.cuh:jac_add_z01_voted_lane) a warp with no P == Q lane
// runs the 6 of the add path alone. Its launch bounds are from ptxas -v
// as for the others (chip_smoke.py phase 1; PERF.md has the registers).
// g1_add_nd (pallas_curve.py:492, the add without the doubling path, for
// operands that are never the same point) runs curve.cuh:jac_add_nd_lane,
// 16 products a lane and no warp vote. Over Fq, one thread a lane with the
// product inlined 16 times (points.cuh's one-thread template, as it was
// built before), it ran 4.4x its bound at 2^16 lanes on an H100; over FqCall it is
// the add path of g1_add_kernel without the doubling path's vote and
// selects. It launches on no path of a proof: JacobianCurve.add_nd.
// Launch bounds from ptxas -v as for the others (chip_smoke.py phase 1).
// g1_double and g1_horner share one element type, G1Dbl: FqCall. The
// Horner's chain is the double's formula 264 times and the add's 22 times
// on one warp. Over Fq, the product inlined, its loop body holds some 30
// copies of the product; called, one. On an H100 (chip_smoke.py --ab
// against a copy of this file with G1Dbl = Fq) the called product made
// g1_horner 1.40x faster (1.464 ms against 2.056 for 22 windows at
// c = 12) and g1_double 1.09x at 2^16 lanes (0.0209 ms against 0.0227),
// 1.17x slower on one lane (8.3 us against 7.1), the width the Horner
// launched it at before it ran in one kernel; ptxas 145 and 80 registers
// against 128 and 64, no spill.
#include "points.cuh"

namespace zkt {
using G1Dbl = FqCall;
constexpr int G1_ADD_MIN_BLOCKS = 3;
constexpr int G1_MADD_ND_MIN_BLOCKS = 4;
constexpr int G1_MADD_MIN_BLOCKS = 3;
constexpr int G1_ADD_Z01_MIN_BLOCKS = 3;
constexpr int G1_ADD_ND_MIN_BLOCKS = 3;
ZKT_LANE_KERNEL(g1_add_kernel, jac_add_lane, FqCall, G1_ADD_MIN_BLOCKS)
ZKT_LANE_KERNEL(g1_madd_nd_kernel, jac_madd_nd_lane, FqCall,
                G1_MADD_ND_MIN_BLOCKS)
ZKT_LANE_KERNEL(g1_madd_kernel, jac_madd_lane, FqCall, G1_MADD_MIN_BLOCKS)
ZKT_LANE_KERNEL(g1_add_z01_kernel, jac_add_z01_voted_lane, FqCall,
                G1_ADD_Z01_MIN_BLOCKS)
ZKT_LANE_KERNEL(g1_add_nd_kernel, jac_add_nd_lane, FqCall,
                G1_ADD_ND_MIN_BLOCKS)
ZKT_HORNER_KERNEL(g1_horner_kernel, G1Dbl, 1)
}  // namespace zkt

ZKT_POINT_API(g1, add, zkt::launch_point<zkt::FqCall>, zkt::g1_add_kernel, 2)
ZKT_POINT_API(g1, madd_nd, zkt::launch_point<zkt::FqCall>,
              zkt::g1_madd_nd_kernel, 2)
ZKT_POINT_API(g1, add_nd, zkt::launch_point<zkt::FqCall>,
              zkt::g1_add_nd_kernel, 2)
ZKT_POINT_API(g1, add_z01, zkt::launch_point<zkt::FqCall>,
              zkt::g1_add_z01_kernel, 2)
ZKT_POINT_API(g1, madd, zkt::launch_point<zkt::FqCall>, zkt::g1_madd_kernel,
              2)
ZKT_POINT_API(g1, double, zkt::launch_point<zkt::G1Dbl>,
              zkt::jac_double_kernel<zkt::G1Dbl>, 1)
ZKT_HORNER_API(g1, zkt::G1Dbl, zkt::g1_horner_kernel)
