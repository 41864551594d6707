// The zkrollup_torch point kernels: six templates over the coordinate field
// E (Fq for G1 in g1.cu, Fq2 for G2 in g2.cu), one launch function each.
//
//   jac_add<E>      replaces pallas_curve.py:g1_add (_add_kernel) and
//                   pallas_curve_g2.py:g2_add
//   jac_add_nd<E>   replaces pallas_curve.py:g1_add_nd (_add_nd_kernel) and
//                   pallas_curve_g2.py:g2_add_nd
//   jac_add_z01<E>  replaces pallas_curve.py:g1_add_z01 (_add_z01_kernel);
//                   over Fq2 it replaces the XLA glue of
//                   weierstrass.py:_add_z01_generic, which has no Pallas
//                   kernel (it differs from that glue in limbs on P + (-P)
//                   lanes only, where the kernel zeroes Z alone)
//   jac_madd_nd<E>  replaces pallas_curve.py:g1_madd_nd and g2_madd_nd
//   jac_madd<E>     replaces pallas_curve.py:g1_madd
//                   (_make_madd_kernel(False)) and g2_madd
//   jac_double<E>   replaces pallas_curve.py:g1_double (_double_kernel) and
//                   g2_double
//
// One thread per lane: load 16-bit limbs from the (n, 16) int32 storage,
// pack them into 8 words in registers, compute, unpack, store. Nothing is
// shared between lanes, so the TPU kernels' (16, TILE) blocking has no
// counterpart here.
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
// so every lane also computes the doubling path. At 64 multiplies per SM
// per clock every point kernel is multiply-bound on the packed bytes; the
// G1 double and the G1 add_z01 come closest to the balance point. Register
// pressure is the other limit: a G1 point add holds ~10 live field
// elements (80 registers); the Fq2 add holds twice that and spills to
// local memory. The point kernels cap blocks at 128 threads
// (__launch_bounds__) and accept the spill rather than split the formula
// across launches: the spill stays in L1 and no intermediate goes to
// device memory. (ptxas -v for sm_90a, CUDA 12.8: jac_add<Fq2> 255
// registers and 172 bytes of spill stores, jac_add_nd<Fq2> and
// jac_add_z01<Fq2> 255 and 60 bytes each, jac_madd<Fq2> 255 and 20 bytes,
// jac_madd_nd<Fq2> 255 and 16 bytes, jac_double<Fq2> 137; over Fq jac_add
// 131, jac_add_nd 142, jac_add_z01 127, jac_madd 128, jac_madd_nd 123,
// jac_double 64, none of them spilling.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"
#include "curve.cuh"
#include "field.cuh"

namespace zkt {

#define ZKT_POINT_KERNEL(NAME, LANE)                                      \
  template <class E>                                                      \
  __global__ void __launch_bounds__(128) NAME(PointArgs args, int64_t n) { \
    int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;           \
    if (i < n) LANE<E>(args, i);                                          \
  }

ZKT_POINT_KERNEL(jac_add_kernel, jac_add_lane)
ZKT_POINT_KERNEL(jac_add_nd_kernel, jac_add_nd_lane)
ZKT_POINT_KERNEL(jac_add_z01_kernel, jac_add_z01_lane)
ZKT_POINT_KERNEL(jac_madd_nd_kernel, jac_madd_nd_lane)
ZKT_POINT_KERNEL(jac_madd_kernel, jac_madd_lane)
ZKT_POINT_KERNEL(jac_double_kernel, jac_double_lane)
#undef ZKT_POINT_KERNEL

// n_in: input points (2 for the adds, 1 for the double)
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

}  // namespace zkt

// The C entry points of one curve: zkt_<G>_<kernel>(in, out, n, stream),
// with in and out arrays of coordinate plane pointers.
#define ZKT_CURVE_API(G, E)                                                \
  extern "C" {                                                             \
  int zkt_##G##_add(void* const* in, void* const* out, int64_t n,          \
                    void* stream) {                                        \
    return zkt::launch_point<E>(zkt::jac_add_kernel<E>, 2, in, out, n,     \
                                stream);                                   \
  }                                                                        \
  int zkt_##G##_add_nd(void* const* in, void* const* out, int64_t n,       \
                       void* stream) {                                     \
    return zkt::launch_point<E>(zkt::jac_add_nd_kernel<E>, 2, in, out, n,  \
                                stream);                                   \
  }                                                                        \
  int zkt_##G##_add_z01(void* const* in, void* const* out, int64_t n,      \
                        void* stream) {                                    \
    return zkt::launch_point<E>(zkt::jac_add_z01_kernel<E>, 2, in, out, n, \
                                stream);                                   \
  }                                                                        \
  int zkt_##G##_madd_nd(void* const* in, void* const* out, int64_t n,      \
                        void* stream) {                                    \
    return zkt::launch_point<E>(zkt::jac_madd_nd_kernel<E>, 2, in, out, n, \
                                stream);                                   \
  }                                                                        \
  int zkt_##G##_madd(void* const* in, void* const* out, int64_t n,         \
                     void* stream) {                                       \
    return zkt::launch_point<E>(zkt::jac_madd_kernel<E>, 2, in, out, n,    \
                                stream);                                   \
  }                                                                        \
  int zkt_##G##_double(void* const* in, void* const* out, int64_t n,       \
                       void* stream) {                                     \
    return zkt::launch_point<E>(zkt::jac_double_kernel<E>, 1, in, out, n,  \
                                stream);                                   \
  }                                                                        \
  }
