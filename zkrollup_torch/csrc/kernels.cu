// The zkrollup_torch CUDA kernels: six templates, eleven instantiations.
//
//   mont_mul<Fr>, mont_mul<Fq>  replace fields/pallas_mont.py:mont_mul
//   butterfly (Fr)              replaces fields/pallas_mont.py:butterfly
//   jac_madd_nd<Fq>, <Fq2>      replace curve/pallas_curve.py:g1_madd_nd and
//                               curve/pallas_curve_g2.py:g2_madd_nd
//   jac_add<Fq>, <Fq2>          replace curve/pallas_curve.py:g1_add and
//                               curve/pallas_curve_g2.py:g2_add
//   jac_double<Fq>, <Fq2>       replace curve/pallas_curve.py:g1_double
//                               (_double_kernel) and
//                               curve/pallas_curve_g2.py:g2_double
//   jac_madd<Fq>, <Fq2>         replace curve/pallas_curve.py:g1_madd
//                               (_make_madd_kernel(False)) and
//                               curve/pallas_curve_g2.py:g2_madd
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
// The storage moves twice those bytes: every coordinate is a 64-byte row
// of 16 int32 limbs, half of each word zero. The kernels are branch-free,
// so every lane also computes the doubling path. At 64 multiplies per SM
// per clock every curve kernel is multiply-bound on the packed bytes; the
// G1 double comes closest to the balance point. Register pressure is the
// other limit: a G1 point add holds ~10 live field elements (80
// registers); the Fq2 add holds twice that and spills to local memory.
// The curve kernels cap
// blocks at 128 threads (__launch_bounds__) and accept the spill rather
// than split the formula across launches: the spill stays in L1 and no
// intermediate goes to device memory. (ptxas -v for sm_90a, CUDA 12.8:
// jac_add<Fq2> 255 registers and 172 bytes of spill stores,
// jac_madd<Fq2> 255 and 20 bytes, jac_madd_nd<Fq2> 255 and 16 bytes,
// jac_double<Fq2> 137; over Fq jac_add 131, jac_madd 128, jac_madd_nd 123,
// jac_double 64; mont_mul 32 and butterfly 40; only the three Fq2 adds
// spill.)
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launch; pointers and the stream are passed as void*.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"
#include "field.cuh"

namespace zkt {

template <class F>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t n, int b_bcast) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F x = F::load(a + i * 16);
  F y = F::load(b + (b_bcast ? 0 : i * 16));
  F::mul(x, y).store(out + i * 16);
}

// One radix-2 NTT stage in place over x (2n rows): lane k takes row
// j = (k / m) * 2m + k % m and row j + m, and writes back
// (x[j] + t[k % m] * x[j + m], x[j] - t[k % m] * x[j + m]). No two lanes
// share a row, so the stage needs no second buffer.
__global__ void __launch_bounds__(256)
butterfly_kernel(int32_t* __restrict__ x, const int32_t* __restrict__ t,
                 int64_t n, int64_t m) {
  int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int64_t tj = k % m;
  int64_t row = (k / m) * 2 * m + tj;
  Fr u = Fr::load(x + row * 16);
  Fr v = Fr::mul(Fr::load(x + (row + m) * 16), Fr::load(t + tj * 16));
  Fr::add(u, v).store(x + row * 16);
  Fr::sub(u, v).store(x + (row + m) * 16);
}

template <class E>
__global__ void __launch_bounds__(128) jac_add_kernel(PointArgs args,
                                                      int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) jac_add_lane<E>(args, i);
}

template <class E>
__global__ void __launch_bounds__(128) jac_madd_nd_kernel(PointArgs args,
                                                          int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) jac_madd_nd_lane<E>(args, i);
}

template <class E>
__global__ void __launch_bounds__(128) jac_double_kernel(PointArgs args,
                                                         int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) jac_double_lane<E>(args, i);
}

template <class E>
__global__ void __launch_bounds__(128) jac_madd_kernel(PointArgs args,
                                                       int64_t n) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) jac_madd_lane<E>(args, i);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return unsigned((n + threads - 1) / threads);
}

// n_in: input points (2 for the adds, 1 for the double)
template <class E>
PointArgs point_args(void* const* in, void* const* out, int n_in = 2) {
  PointArgs args = {};
  for (int k = 0; k < 3 * n_in * Planes<E>::K; ++k)
    args.in[k] = static_cast<const int32_t*>(in[k]);
  for (int k = 0; k < 3 * Planes<E>::K; ++k)
    args.out[k] = static_cast<int32_t*>(out[k]);
  return args;
}

template <class E>
int launch_add(void* const* in, void* const* out, int64_t n, void* stream) {
  if (n > 0)
    jac_add_kernel<E><<<blocks_for(n, 128), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        point_args<E>(in, out), n);
  return int(cudaGetLastError());
}

template <class E>
int launch_madd_nd(void* const* in, void* const* out, int64_t n,
                   void* stream) {
  if (n > 0)
    jac_madd_nd_kernel<E><<<blocks_for(n, 128), 128, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        point_args<E>(in, out), n);
  return int(cudaGetLastError());
}

template <class E>
int launch_double(void* const* in, void* const* out, int64_t n,
                  void* stream) {
  if (n > 0)
    jac_double_kernel<E><<<blocks_for(n, 128), 128, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        point_args<E>(in, out, 1), n);
  return int(cudaGetLastError());
}

template <class E>
int launch_madd(void* const* in, void* const* out, int64_t n, void* stream) {
  if (n > 0)
    jac_madd_kernel<E><<<blocks_for(n, 128), 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        point_args<E>(in, out), n);
  return int(cudaGetLastError());
}

template <class F>
int launch_mont_mul(const void* a, const void* b, int b_bcast, void* out,
                    int64_t n, void* stream) {
  if (n > 0)
    mont_mul_kernel<F><<<blocks_for(n, 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<int32_t*>(out), n, b_bcast);
  return int(cudaGetLastError());
}

}  // namespace zkt

extern "C" {

// The library links its own CUDA runtime, whose current device is set here
// before each launch; tensors and streams come from PyTorch.
int zkt_set_device(int device) { return int(cudaSetDevice(device)); }

const char* zkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int zkt_mont_mul_fr(const void* a, const void* b, int b_bcast, void* out,
                    int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fr>(a, b, b_bcast, out, n, stream);
}

int zkt_mont_mul_fq(const void* a, const void* b, int b_bcast, void* out,
                    int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fq>(a, b, b_bcast, out, n, stream);
}

int zkt_butterfly_fr(void* x, const void* t, int64_t n, int64_t m,
                     void* stream) {
  if (n > 0)
    zkt::butterfly_kernel<<<zkt::blocks_for(n, 256), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(x), static_cast<const int32_t*>(t), n, m);
  return int(cudaGetLastError());
}

int zkt_g1_add(void* const* in, void* const* out, int64_t n, void* stream) {
  return zkt::launch_add<zkt::Fq>(in, out, n, stream);
}

int zkt_g1_madd_nd(void* const* in, void* const* out, int64_t n,
                   void* stream) {
  return zkt::launch_madd_nd<zkt::Fq>(in, out, n, stream);
}

int zkt_g2_add(void* const* in, void* const* out, int64_t n, void* stream) {
  return zkt::launch_add<zkt::Fq2>(in, out, n, stream);
}

int zkt_g2_madd_nd(void* const* in, void* const* out, int64_t n,
                   void* stream) {
  return zkt::launch_madd_nd<zkt::Fq2>(in, out, n, stream);
}

int zkt_g1_double(void* const* in, void* const* out, int64_t n,
                  void* stream) {
  return zkt::launch_double<zkt::Fq>(in, out, n, stream);
}

int zkt_g2_double(void* const* in, void* const* out, int64_t n,
                  void* stream) {
  return zkt::launch_double<zkt::Fq2>(in, out, n, stream);
}

int zkt_g1_madd(void* const* in, void* const* out, int64_t n, void* stream) {
  return zkt::launch_madd<zkt::Fq>(in, out, n, stream);
}

int zkt_g2_madd(void* const* in, void* const* out, int64_t n, void* stream) {
  return zkt::launch_madd<zkt::Fq2>(in, out, n, stream);
}

}  // extern "C"
