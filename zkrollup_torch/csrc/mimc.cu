// mimc_sponge[fr]: the MiMCSponge multi-hash of every lane in one launch.
//
// Replaces zkrollup/hash/mimc_jax.py:64 multi_hash_mont and its :41
// permute_mont, the 220-round Feistel as a lax.scan inside a jitted
// program whose body is three Montgomery products and three adds on the
// whole batch (XLA; no Pallas kernel). The port's route before this one
// ran that scan as a Python loop, a mont_mul[fr] launch a product and a
// host-synced carry loop an add: over 24,000 launches a Merkle level.
//
// Per lane, as the reference: r = c = 0; for each input x_j, r = r + x_j,
// then (r, c) = permute(r, c) under key k. Each round: t = (xl + k) +
// c_i, t^5 from three products (t^2, t^4, t^4 t), (xl, xr) <- (xr + t^5,
// xl). The scan swaps on the last round too; the swap back after it
// leaves xl as it was and xr + t^5 in xr, MiMC's last round.
//
// Design: one thread a lane, its state (xl, xr), k and t in registers for
// all rounds and inputs; one launch reads a lane's inputs once and writes
// its hash once. The 220 round constants (7,040 B packed) sit in shared
// memory, loaded once a block: every thread of a warp reads the same
// constant in the same round, a broadcast. The product is Fr's CIOS
// (Fp::mul, field.cuh), inlined, as in mont_mul_kernel<Fr>.
//
// Bound by the integer multiplier: 3 products a round, 660 an input (a
// pair hash 1,320, a four-wide leaf row 2,640) of 264 multiplies each,
// against a few values of 32 B a lane. One lane's chain of dependent
// products is its latency bound.
//
// Storage at the boundary is the (n, 16) int32 rows of 16-bit limbs of
// the other kernels, Montgomery form (R = 2^256); in registers a value is
// 8 packed words. Inputs are canonical (< r), as the reference's.
#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"
#include "field.cuh"

namespace zkt {

constexpr int MIMC_THREADS = 128;
constexpr int MIMC_ROUNDS = 220;

// in: (n, n_in, 16) rows; key: null (k = 0), one row (key_bcast) or
// (n, 16); cts: the (MIMC_ROUNDS, 16) round constants; out: (n, 16).
__global__ void __launch_bounds__(MIMC_THREADS)
mimc_sponge_kernel(const int32_t* __restrict__ in, int n_in,
                   const int32_t* __restrict__ key, int key_bcast,
                   const int32_t* __restrict__ cts,
                   int32_t* __restrict__ out, int64_t n) {
  __shared__ uint4 cs[MIMC_ROUNDS][2];
  for (int r = threadIdx.x; r < MIMC_ROUNDS; r += blockDim.x) {
    const Fr c = Fr::load(cts + r * 16);
    cs[r][0] = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
    cs[r][1] = make_uint4(c.w[4], c.w[5], c.w[6], c.w[7]);
  }
  __syncthreads();
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fr k = key ? Fr::load(key + (key_bcast ? 0 : i) * 16) : Fr::zero();
  Fr xl = Fr::zero(), xr = Fr::zero();
#pragma unroll 1
  for (int j = 0; j < n_in; ++j) {
    xl = Fr::add(xl, Fr::load(in + (i * n_in + j) * 16));
#pragma unroll 1
    for (int r = 0; r < MIMC_ROUNDS; ++r) {
      const uint4 lo = cs[r][0], hi = cs[r][1];
      const Fr c = {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
      const Fr t = Fr::add(Fr::add(xl, k), c);
      const Fr t2 = Fr::mul(t, t);
      const Fr t4 = Fr::mul(t2, t2);
      const Fr nl = Fr::add(xr, Fr::mul(t4, t));
      xr = xl;
      xl = nl;
    }
    const Fr s = xl;  // the swap back
    xl = xr;
    xr = s;
  }
  xl.store(out + i * 16);
}

}  // namespace zkt

extern "C" {

// The sponge over n lanes of n_in inputs each (n_in >= 1).
int zkt_mimc_sponge_fr(const void* in, int n_in, const void* key,
                       int key_bcast, const void* cts, void* out, int64_t n,
                       void* stream) {
  if (n_in < 1) return int(cudaErrorInvalidValue);
  if (n > 0)
    zkt::mimc_sponge_kernel<<<zkt::blocks_for(n, zkt::MIMC_THREADS),
                              zkt::MIMC_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in), n_in,
        static_cast<const int32_t*>(key), key_bcast,
        static_cast<const int32_t*>(cts), static_cast<int32_t*>(out), n);
  return int(cudaGetLastError());
}

}  // extern "C"
