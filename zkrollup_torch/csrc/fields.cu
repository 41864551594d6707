// The zkrollup_torch field kernels: two templates, three instantiations.
//
//   mont_mul<Fr>, mont_mul<Fq>  replace fields/pallas_mont.py:mont_mul
//   butterfly (Fr)              replaces fields/pallas_mont.py:butterfly
//
// One thread per lane: load 16-bit limbs from the (n, 16) int32 storage,
// pack them into 8 words in registers, compute, unpack, store. Nothing is
// shared between lanes, so the TPU kernels' (16, TILE) blocking has no
// counterpart here.
//
// What bounds them on the H100: device memory. One product is 264
// mad.lo/mad.hi/mul.lo instructions against 3 values of 32 B read and
// written (the storage moves twice that: every value is a 64-byte row of
// 16 int32 limbs, half of each word zero), so at 64 multiplies per SM per
// clock both sit on the bytes side of the balance point. (ptxas -v for
// sm_90a, CUDA 12.8: mont_mul 32 registers, butterfly 40; no spill.)
#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"
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

}  // extern "C"
