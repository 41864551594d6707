// The zkrollup_torch point kernels: the lanes of curve.cuh over the
// coordinate field E, one launch function each. Two are templates over E
// (g1.cu's g1_add_nd over Fq and g1_double over FqCall); the add, both
// mixed adds and the z01 add are built over FqCall (fq_call.cuh, one
// thread a G1 lane, g1.cu's g1_add, g1_madd_nd, g1_madd and g1_add_z01)
// and over Fq2Pair (two threads a G2 lane, g2.cu's g2_add, g2_madd_nd,
// g2_madd and g2_add_z01), and so are the double and the add without the
// doubling path over Fq2Pair (g2_double, g2_add_nd).
// The Horner kernels run the MSM's whole combine on one warp (g1_horner
// over FqCall, g2_horner over Fq2Pair).
//
//   jac_add         replaces pallas_curve.py:g1_add (_add_kernel) over
//                   FqCall (g1_add_kernel); over Fq2Pair (jac_add_pair)
//                   pallas_curve_g2.py:g2_add
//   jac_add_nd      replaces pallas_curve.py:g1_add_nd (_add_nd_kernel)
//                   over Fq; over Fq2Pair (jac_add_nd_pair)
//                   pallas_curve_g2.py:g2_add_nd
//   jac_add_z01     (its doubling path voted per warp) replaces
//                   pallas_curve.py:g1_add_z01 (_add_z01_kernel) over
//                   FqCall (g1_add_z01_kernel); over Fq2Pair
//                   (jac_add_z01_pair) the XLA glue of
//                   weierstrass.py:_add_z01_generic, which has no Pallas
//                   kernel (it differs from that glue in limbs on P + (-P)
//                   lanes only, where the kernel zeroes Z alone)
//   jac_madd_nd     replaces pallas_curve.py:g1_madd_nd over FqCall
//                   (g1_madd_nd_kernel); over Fq2Pair (jac_madd_nd_pair)
//                   pallas_curve_g2.py:g2_madd_nd
//   jac_madd        replaces pallas_curve.py:g1_madd
//                   (_make_madd_kernel(False)) over FqCall (g1_madd_kernel);
//                   over Fq2Pair (jac_madd_pair) pallas_curve_g2.py:g2_madd
//   jac_double<E>   replaces pallas_curve.py:g1_double (_double_kernel)
//                   over FqCall; over Fq2Pair (jac_double_pair)
//                   pallas_curve_g2.py:g2_double
//   horner          replaces the device Horner of zkrollup/msm/msm.py:msm
//                   (a fori_loop of c doubles and one add a window on one
//                   point: 286 launches a curve at c = 12) with one launch
//                   of one warp (g1_horner_kernel, g2_horner_kernel)
//
// One thread per lane (two for the Fq2Pair kernels): load 16-bit limbs from
// the (n, 16) int32 storage, pack them into 8 words in registers, compute,
// unpack, store. Nothing is shared between lanes, so the TPU kernels'
// (16, TILE) blocking has no counterpart here.
//
// What bounds them on the H100: the 32-bit multiply rate (one CIOS
// product is 264 mad.lo/mad.hi/mul.lo instructions; a point add is 11-16
// products over Fq, about three times that over Fq2) against device memory.
// Per lane, in Fq products (the add path, + the doubling path that only
// P == Q lanes need) and point values read + written (a coordinate is 32 B
// of value, so a G1 point is 96 B and a G2 point 192 B):
//   jac_double  G1  7 products,  96 +  96 B;  G2 16 products, 192 + 192 B
//   jac_madd    G1 11 + 6,      192 +  96 B;  G2 30 + 13,     384 + 192 B
//   jac_madd_nd G1 11,          192 +  96 B;  G2 30,          384 + 192 B
//   jac_add     G1 16 + 7,      192 +  96 B;  G2 44 + 16,     384 + 192 B
//   jac_add_nd  G1 16,          192 +  96 B;  G2 44,          384 + 192 B
//   jac_add_z01 G1 6 + 6,       192 +  96 B;  G2 16 + 13,     384 + 192 B
// The storage moves twice those bytes: every coordinate is a 64-byte row
// of 16 int32 limbs, half of each word zero. The kernels are branch-free,
// so every lane also computes the doubling path, but for g1_add, the
// mixed adds, the z01 adds and the Horner's add, which compute it only in
// warps that need it. At 64 multiplies per SM
// per clock every point kernel is multiply-bound on the packed bytes; the
// G1 double and the G1 add_z01 come closest to the balance point.
//
// The Horner kernels are the exception: one chain of W c doubles and W
// adds (c = 12, W = 22 on the MSM's 256-bit scalars: 264 doubles, 22 adds)
// on one warp, a few hundred bytes read. What bounds them is the latency
// of that chain: a warp issues a 32-bit multiply every 2 clocks (16 a clock
// an SM sub-partition), and each product depends on the one before. One
// launch replaces the 286 one-lane launches of the route before it, each
// of which paid a launch and a round trip of its point through memory.
//
// Register pressure and latency are the other limit. A G1 point add holds
// ~10 live field elements (80 registers); one thread computing an Fq2 add
// holds twice that, reaches 255 registers and spills, so an SM holds 8
// warps, each on a long serial chain of 3 CIOS products an Fq2 product.
// The one-thread kernels cap blocks at 128 threads (__launch_bounds__) and
// accept the spill: it stays in L1 and no intermediate goes to device
// memory. (ptxas -v for sm_90a, CUDA 12.8: over Fq jac_add_nd 142
// registers, no spill. jac_add<Fq2>, jac_madd_nd<Fq2>, jac_madd<Fq2>,
// jac_add_z01<Fq2> and jac_add_nd<Fq2>, which g2.cu no longer builds,
// took 255 and spilled 172, 16, 20, 60 and 60 bytes, and jac_double<Fq2>
// 137 with no spill; jac_add<Fq>, jac_madd_nd<Fq>, jac_madd<Fq>,
// jac_double<Fq> and jac_add_z01<Fq>, which g1.cu no longer builds, 131,
// 123, 128, 64 and 127.) Over FqCall, its product called, the G1 kernels fit
// without spill at the launch bounds of g1.cu, whose comment gives their
// registers. The Fq2Pair kernels
// (fq2_pair.cuh) halve both: 8 registers a value and half the chain a
// thread, each Fq2 product one Montgomery reduction of two unreduced
// products; their launch bounds and ptxas figures are in g2.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"
#include "curve.cuh"
#include "field.cuh"
#include "fq2_pair.cuh"
#include "fq_call.cuh"

namespace zkt {

#define ZKT_POINT_KERNEL(NAME, LANE)                                      \
  template <class E>                                                      \
  __global__ void __launch_bounds__(128) NAME(PointArgs args, int64_t n) { \
    int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;           \
    if (i < n) LANE<E>(args, i);                                          \
  }

ZKT_POINT_KERNEL(jac_double_kernel, jac_double_lane)
#undef ZKT_POINT_KERNEL

// A kernel of one thread a lane over E with at least MIN_BLOCKS blocks of
// 128 threads resident an SM (g1.cu's g1_add, g1_madd_nd, g1_madd,
// g1_add_z01 and g1_add_nd over FqCall).
// Past the ragged edge a thread computes lane n - 1 again and stores
// nothing, so that every thread of a warp reaches a warp vote.
#define ZKT_LANE_KERNEL(NAME, LANE, E, MIN_BLOCKS)                         \
  __global__ void __launch_bounds__(128, MIN_BLOCKS)                      \
      NAME(PointArgs args, int64_t n) {                                   \
    const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;     \
    LANE<E>(args, i < n ? i : n - 1, i < n);                              \
  }

// A kernel of two threads a lane over Fq2Pair, lane i on threads 2i and
// 2i+1. Past the ragged edge a thread computes lane n - 1 again, so that
// every thread of a warp reaches the shuffles, and stores nothing.
// Launch bounds from ptxas -v for sm_90a (chip_smoke.py phase 1): at 128
// threads a block and 3 blocks an SM (12 warps) the paired kernels fit
// with no spill (g2.cu). A block is whole warps, so every warp is full
// and both threads of a pair sit in one warp.
constexpr int PAIR_THREADS = 128;
constexpr int PAIR_MIN_BLOCKS = 3;
static_assert(PAIR_THREADS % 32 == 0,
              "a paired kernel's block must be whole warps");
#define ZKT_PAIR_KERNEL(NAME, LANE)                                          \
  __global__ void __launch_bounds__(PAIR_THREADS, PAIR_MIN_BLOCKS)           \
      NAME(PointArgs args, int64_t n) {                                      \
    const int64_t i =                                                        \
        (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 1;               \
    LANE<Fq2Pair>(args, i < n ? i : n - 1, i < n);                           \
  }

// A Horner kernel (curve.cuh:horner_lane over E): one warp, every thread
// on the same chain, so that every thread reaches the add's warp vote and
// Fq2Pair's shuffles; only the STORERS threads of lane 0 store (1 for a
// one-thread type, 2 for Fq2Pair). One warp needs no occupancy, so the
// launch bounds ask for no minimum of blocks.
#define ZKT_HORNER_KERNEL(NAME, E, STORERS)                                \
  __global__ void __launch_bounds__(32)                                   \
      NAME(PointArgs args, int64_t W, int c) {                            \
    horner_lane<E>(args, W, c, threadIdx.x < (STORERS));                  \
  }

// n_in: input points (2 for the adds, 1 for the double and the Horner)
template <class E>
PointArgs point_args(void* const* in, void* const* out, int n_in) {
  PointArgs args = {};
  for (int k = 0; k < 3 * n_in * Planes<E>::K; ++k)
    args.in[k] = static_cast<const int32_t*>(in[k]);
  for (int k = 0; k < 3 * Planes<E>::K; ++k)
    args.out[k] = static_cast<int32_t*>(out[k]);
  return args;
}

using PointKernel = void (*)(PointArgs, int64_t);

template <class E>
int launch_point(PointKernel kernel, int n_in, void* const* in,
                 void* const* out, int64_t n, void* stream) {
  if (n > 0)
    kernel<<<blocks_for(n, 128), 128, 0,
             static_cast<cudaStream_t>(stream)>>>(
        point_args<E>(in, out, n_in), n);
  return int(cudaGetLastError());
}

// The launch of an Fq2Pair kernel: 2n threads, PAIR_THREADS a block.
inline int launch_pair(PointKernel kernel, int n_in, void* const* in,
                       void* const* out, int64_t n, void* stream) {
  if (n > 0)
    kernel<<<blocks_for(2 * n, PAIR_THREADS), PAIR_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        point_args<Fq2Pair>(in, out, n_in), n);
  return int(cudaGetLastError());
}

using HornerKernel = void (*)(PointArgs, int64_t, int);

// The launch of a Horner kernel: one block of one warp; in holds the W
// rows of the window sums, out one row.
template <class E>
int launch_horner(HornerKernel kernel, void* const* in, void* const* out,
                  int64_t W, int c, void* stream) {
  kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      point_args<E>(in, out, 1), W, c);
  return int(cudaGetLastError());
}

}  // namespace zkt

// One C entry point: zkt_<G>_<NAME>(in, out, n, stream), with in and out
// arrays of coordinate plane pointers; LAUNCH is launch_point<E> or
// launch_pair, KERNEL its kernel, N_IN its input points (2 for the adds, 1
// for the double).
#define ZKT_POINT_API(G, NAME, LAUNCH, KERNEL, N_IN)                        \
  extern "C" int zkt_##G##_##NAME(void* const* in, void* const* out,        \
                                  int64_t n, void* stream) {                \
    return LAUNCH(KERNEL, N_IN, in, out, n, stream);                        \
  }

// The Horner's C entry point: zkt_<G>_horner(in, out, W, c, stream), with
// in the X Y Z planes of the (W, 16) window sums and out those of one row;
// KERNEL is its kernel over E.
#define ZKT_HORNER_API(G, E, KERNEL)                                        \
  extern "C" int zkt_##G##_horner(void* const* in, void* const* out,        \
                                  int64_t W, int c, void* stream) {         \
    return zkt::launch_horner<E>(KERNEL, in, out, W, c, stream);            \
  }
