// The zkrollup_torch field kernels.
//
//   mont_mul<Fr>, mont_mul<Fq>  replace fields/pallas_mont.py:mont_mul
//   ntt_pass (Fr)               replaces fields/pallas_mont.py:butterfly
//   fold (Fr)                   no Pallas kernel: the carry pass and the
//                               two-product fold of groth16/prove.py:_spmv
//
// Storage at every boundary is (n, 16) int32 rows of 16-bit limbs; in
// registers and shared memory a value is 8 packed 32-bit words.
//
// mont_mul: MONT_MUL_PER_THREAD lanes a thread (one: two and four were
// slower), the loads of all of them issued before the first product; this
// form of the one-lane kernel ran 5-25% faster than the same lane written
// as one expression (PERF.md §6). b may be one broadcast element, or
// gathered through an int64 row index (b[idx[i]]), so a gathered operand
// is never materialised. Bound by device memory: 264 multiplies against 3
// values of 32 B (the 64-byte rows move twice that).
//
// ntt_pass: a range of k consecutive radix-2 DIT stages in one launch. A
// block loads a tile of up to 2^NTT_TILE_LOG rows made of sets of 2^k
// rows whose indices differ only in the bits of those stages (row stride
// 2^s0; neighbouring sets on consecutive rows, so that a warp's loads are
// contiguous), runs the k stages on it in shared memory and writes it
// back: a 2^17 transform is two passes (stages 0-9, 10-16), each reading
// and writing every row once, in place of 17 launches that each read and
// write every row. The first pass of a transform gathers its rows by
// bit-reversed index as it loads (so it runs out of place) and may
// multiply each input row by a table (pre) or form it from three inputs
// ((x * b - c) * z, the quotient's pointwise step); the last may multiply
// each output row by a table (post). Each stage is the DIT butterfly of
// pallas_mont.py:butterfly, (u, v) <- (u + w v, u - w v). Bound by the
// integer multiplier: 17 x 2^16 products of 264 multiplies against two
// passes of 2^17 x 64 B read and written.
//
// fold: the (n, 16) int64 lazy limb sums V < 2^288 that index_add_ leaves
// -> V mod r, the carries propagated in 64-bit registers, then
// lo * R * R^-1 + hi * R^2 * R^-1 with lo = V mod 2^256, hi = V >> 256.
// Bound by device memory: 128 B read and 64 B written a row.
#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"
#include "field.cuh"

namespace zkt {

constexpr int MONT_MUL_THREADS = 256;
constexpr int MONT_MUL_PER_THREAD = 1;

template <class F, int PER>
__global__ void __launch_bounds__(MONT_MUL_THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int64_t* __restrict__ b_idx, int32_t* __restrict__ out,
                int64_t n, int b_bcast) {
  const int64_t i0 = int64_t(blockIdx.x) * blockDim.x * PER + threadIdx.x;
  F x[PER], y[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t i = i0 + int64_t(k) * blockDim.x;
    if (i < n) {
      const int64_t bi = b_bcast ? 0 : (b_idx ? b_idx[i] : i);
      x[k] = F::load(a + i * 16);
      y[k] = F::load(b + bi * 16);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t i = i0 + int64_t(k) * blockDim.x;
    if (i < n) F::mul(x[k], y[k]).store(out + i * 16);
  }
}

constexpr int NTT_TILE_LOG = 10;  // 1024 rows: 32 KB of shared memory
constexpr int NTT_TILE = 1 << NTT_TILE_LOG;
constexpr int NTT_THREADS = 256;

struct NttPass {
  const int32_t* x;     // (batch, n, 16) input rows
  int32_t* out;         // (batch, n, 16) output rows; may be x unless bitrev
  const int32_t* tw;    // twiddles: stage s, index j at row 2^s + j - tw_origin
  const int32_t* pre;   // (n, 16) by input row, or null
  const int32_t* post;  // (n, 16) by output row, one row if post_bcast, or null
  const int32_t* pw_b;  // prologue x <- (x * pw_b - pw_c) * pw_z[0], or null
  const int32_t* pw_c;
  const int32_t* pw_z;
  int64_t n, tw_origin;
  // a tile holds 2^(glo + ghi) sets of 2^k rows: 2^glo neighbours below
  // 2^s0, times 2^ghi sets 2^(s0 + k) rows apart
  int log_n, s0, k, glo, ghi, bitrev, post_bcast;
};

__device__ __forceinline__ Fr smem_load(uint32_t (*sm)[NTT_TILE], int e) {
  Fr r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.w[w] = sm[w][e];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t (*sm)[NTT_TILE], int e,
                                           const Fr& v) {
#pragma unroll
  for (int w = 0; w < NW; ++w) sm[w][e] = v.w[w];
}

// One row or one butterfly at a time a thread, in loops strided by the
// block: 48 registers, so that five blocks of 256 threads fit an SM. (A
// thread that issued all its loads first took 124 registers and two
// blocks an SM, and lost: PERF.md §6.)
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const NttPass P) {
  // word-major: a warp reading word w of 32 consecutive elements touches
  // 32 banks (the natural [element][8] layout would hit each bank 8 times)
  __shared__ uint32_t sm[NW][NTT_TILE];
  const int k = P.k, glo = P.glo, glog = P.glo + P.ghi;
  const int tile = 1 << (k + glog);
  const int gmask = (1 << glog) - 1, lomask = (1 << glo) - 1;
  const int64_t lo_blocks = (int64_t(1) << P.s0) >> glo;
  const int64_t lo = (int64_t(blockIdx.x) % lo_blocks) << glo;
  const int64_t hi = int64_t(blockIdx.x) / lo_blocks;
  const int64_t stride = int64_t(1) << P.s0;
  const int64_t span = int64_t(1) << (P.s0 + k);
  const int64_t base = lo + ((hi << P.ghi) << (P.s0 + k));
  const int64_t boff = int64_t(blockIdx.y) * P.n * 16;
  // tile element e = j * 2^glog + g holds row
  // base + (g mod 2^glo) + (g >> glo) * 2^(s0 + k) + j * 2^s0
  auto row = [&](int e) {
    const int g = e & gmask;
    return base + (g & lomask) + int64_t(g >> glo) * span +
           int64_t(e >> glog) * stride;
  };

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t i = row(e);
    const int64_t src =
        !P.bitrev ? i
        : P.log_n ? int64_t(__brevll(uint64_t(i)) >> (64 - P.log_n))
                  : 0;
    Fr v = Fr::load(P.x + boff + src * 16);
    if (P.pw_b)
      v = Fr::mul(Fr::sub(Fr::mul(v, Fr::load(P.pw_b + boff + src * 16)),
                          Fr::load(P.pw_c + boff + src * 16)),
                  Fr::load(P.pw_z));
    if (P.pre) v = Fr::mul(v, Fr::load(P.pre + src * 16));
    smem_store(sm, e, v);
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const int64_t m = int64_t(1) << (P.s0 + t);
    const int half = 1 << t;
    for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
      const int g = q & gmask;
      const int r = q >> glog;
      const int jlo = r & (half - 1);
      const int eu = ((((r >> t) << (t + 1)) | jlo) << glog) | g;
      const int ev = eu + (half << glog);
      // the twiddle index is the row of u mod m
      const int64_t tj = lo + (g & lomask) + int64_t(jlo) * stride;
      const Fr w = Fr::load(P.tw + (m + tj - P.tw_origin) * 16);
      const Fr u = smem_load(sm, eu);
      const Fr v = Fr::mul(smem_load(sm, ev), w);
      smem_store(sm, eu, Fr::add(u, v));
      smem_store(sm, ev, Fr::sub(u, v));
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t i = row(e);
    Fr v = smem_load(sm, e);
    if (P.post)
      v = Fr::mul(v, Fr::load(P.post + (P.post_bcast ? 0 : i) * 16));
    v.store(P.out + boff + i * 16);
  }
}

__global__ void __launch_bounds__(256)
fold_fr_kernel(const int64_t* __restrict__ sums,
               const int32_t* __restrict__ one,
               const int32_t* __restrict__ r2, int32_t* __restrict__ out,
               int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const longlong2* v = reinterpret_cast<const longlong2*>(sums + i * 16);
  Fr lo, hi = Fr::zero();
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const longlong2 q = v[w];
    const uint64_t t0 = uint64_t(q.x) + carry;
    const uint64_t t1 = uint64_t(q.y) + (t0 >> 16);
    carry = t1 >> 16;
    lo.w[w] = uint32_t(t0 & 0xffffu) | (uint32_t(t1 & 0xffffu) << 16);
  }
  hi.w[0] = uint32_t(carry);  // V < 2^288: the carry out of 2^256 is hi
  Fr::add(Fr::mul(lo, Fr::load(one)), Fr::mul(hi, Fr::load(r2)))
      .store(out + i * 16);
}

template <class F>
int launch_mont_mul(const void* a, const void* b, const void* b_idx,
                    int b_bcast, void* out, int64_t n, void* stream) {
  constexpr int per = MONT_MUL_PER_THREAD;
  if (n > 0)
    mont_mul_kernel<F, per>
        <<<blocks_for(n, MONT_MUL_THREADS * per), MONT_MUL_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
            static_cast<const int64_t*>(b_idx), static_cast<int32_t*>(out),
            n, b_bcast);
  return int(cudaGetLastError());
}

}  // namespace zkt

extern "C" {

int zkt_mont_mul_fr(const void* a, const void* b, const void* b_idx,
                    int b_bcast, void* out, int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fr>(a, b, b_idx, b_bcast, out, n, stream);
}

int zkt_mont_mul_fq(const void* a, const void* b, const void* b_idx,
                    int b_bcast, void* out, int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fq>(a, b, b_idx, b_bcast, out, n, stream);
}

// Stages s0 .. s0 + k - 1 (k <= NTT_TILE_LOG) over `batch` transforms of n
// rows (n a multiple of 2^(s0 + k); a power of two 2^log_n if bitrev).
int zkt_ntt_pass_fr(const void* x, void* out, const void* tw,
                    int64_t tw_origin, const void* pre, const void* post,
                    int post_bcast, const void* pw_b, const void* pw_c,
                    const void* pw_z, int64_t batch, int64_t n, int log_n,
                    int s0, int k, int bitrev, void* stream) {
  if (k < 0 || k > zkt::NTT_TILE_LOG || s0 < 0 || n <= 0 || batch <= 0 ||
      batch > 65535 || n % (int64_t(1) << (s0 + k)))
    return int(cudaErrorInvalidValue);
  // a tile of up to NTT_TILE rows: sets of 2^k rows, first neighbours
  // below 2^s0, then sets 2^(s0 + k) rows apart, as far as n goes
  const int glog = zkt::NTT_TILE_LOG - k;
  const int glo = glog < s0 ? glog : s0;
  int ghi = glog - glo;
  while (ghi > 0 && n % (int64_t(1) << (s0 + k + ghi))) --ghi;
  const int64_t tile = int64_t(1) << (k + glo + ghi);
  zkt::NttPass p{static_cast<const int32_t*>(x),  static_cast<int32_t*>(out),
                 static_cast<const int32_t*>(tw), static_cast<const int32_t*>(pre),
                 static_cast<const int32_t*>(post),
                 static_cast<const int32_t*>(pw_b),
                 static_cast<const int32_t*>(pw_c),
                 static_cast<const int32_t*>(pw_z),
                 n, tw_origin, log_n, s0, k, glo, ghi, bitrev, post_bcast};
  const dim3 grid(unsigned(n / tile), unsigned(batch));
  zkt::ntt_pass_kernel<<<grid, zkt::NTT_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

int zkt_fold_fr(const void* sums, const void* one, const void* r2, void* out,
                int64_t n, void* stream) {
  if (n > 0)
    zkt::fold_fr_kernel<<<zkt::blocks_for(n, 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(sums), static_cast<const int32_t*>(one),
        static_cast<const int32_t*>(r2), static_cast<int32_t*>(out), n);
  return int(cudaGetLastError());
}

}  // extern "C"
