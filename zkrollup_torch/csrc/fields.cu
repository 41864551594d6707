// The zkrollup_torch field kernels.
//
//   mont_mul<Fr>, mont_mul<Fq>  replace fields/pallas_mont.py:mont_mul
//   ntt_pass (Fr)               replaces fields/pallas_mont.py:butterfly
//   fold (Fr)                   no Pallas kernel: the carry pass and the
//                               two-product fold of groth16/prove.py:_spmv
//   inv<Fq>, inv<Fq2>           no Pallas kernel: the Fermat inversion of
//                               zkrollup/fields/mont.py:159 (mont_pow_const,
//                               a chain of mont_mul) and fq2.py:51 (inv)
//   add<Fr|Fq>, sub<Fr|Fq>      no Pallas kernel: FieldCtx.add / sub of
//                               zkrollup/fields/mont.py:71,76, two 16-step
//                               lax.scan carry chains inside the traced
//                               program
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
//
// inv: a^-1 of every lane in the Montgomery domain (aR -> a^-1 R,
// canonical), 0 -> 0, over Fq (inv[fq]) and over Fq2 through the Fq
// inverse of the norm, 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
// (inv[fq2]). The route it replaces launched mont_mul once per product of
// the exponent chain, 362 dependent launches a call, and inverted each
// lane on its own. Here a thread takes INV_PER_THREAD lanes, t, t + T, ...
// (T threads: a warp's loads are contiguous rows), and inverts them by
// Montgomery's trick: the prefix products forward, kept in the output rows
// (re-read on the back sweep from L2); ONE inversion of their product,
// a^(q - 2) square-and-multiply over the fixed exponent in registers (253
// squares, 109 products); then back, inv_j = acc prefix_{j-1} and
// acc = acc a_j. A zero lane enters the product as one and stores zero.
// Products: 3 a lane over Fq, 7 over Fq2 (the norm 2, back 2, the two
// coordinates 2; the norm waits in the second output row between the
// sweeps), plus 362 a thread. Bound by the integer multiplier: at 16
// lanes a thread about 25 products a lane (29 over Fq2) against 64 B (128
// B) of values read and written; one lane is one thread's chain of 362
// dependent products, bound by its latency.
//
// add / sub: (a + b) mod p and (a - b) mod p, one lane a thread, Fp::add
// (the sum over 8 words and one trial subtraction of p) and Fp::sub (the
// difference and p added back under the borrow's mask), branch-free. The
// reference keeps both inside its traced program; the port's route they
// replace normalised lazy limbs in a Python loop that read a carry flag
// back to the host on every pass. Either operand may be one row broadcast
// over the lanes. Contract: both operands canonical (< p), as the
// reference's "Caller ensures" (zkrollup/fields/limbs.py:111); a value at
// or above p gives a wrong result, not an error (the plain versions,
// cuda_mont.add_plain / sub_plain, take any int64 limbs). Bound by device
// memory: 3 values of 32 B a lane (the 64-byte rows move twice that).
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

constexpr int ADD_SUB_THREADS = 256;

// a_step, b_step: 16 (a row a lane) or 0 (one broadcast row)
template <class F>
__global__ void __launch_bounds__(ADD_SUB_THREADS)
add_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int64_t a_step, int64_t b_step, int32_t* __restrict__ out,
           int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    F::add(F::load(a + i * a_step), F::load(b + i * b_step))
        .store(out + i * 16);
}

template <class F>
__global__ void __launch_bounds__(ADD_SUB_THREADS)
sub_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int64_t a_step, int64_t b_step, int32_t* __restrict__ out,
           int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n)
    F::sub(F::load(a + i * a_step), F::load(b + i * b_step))
        .store(out + i * 16);
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

// Lanes a thread: more buy fewer chains a lane and fewer threads to hide
// a chain's latency. On an H100 (chip_smoke.py --ab) 8 ran inv[fq] 2.5x
// slower at the setup's 482,413 lanes and inv[fq2] 1.13x faster at 2^17;
// 32 ran 1.24x faster and 1.36x slower there. 16 sums least over the
// setup's two launches.
constexpr int INV_THREADS = 128;
constexpr int INV_PER_THREAD = 16;

// The product of the inversion's chain and sweeps: Fq's, inlined (called,
// as FqCall's, it ran as fast at 482,413 lanes and 6% slower on one lane:
// chip_smoke.py --ab).
ZKT_HD Fq inv_mul(const Fq& a, const Fq& b) { return Fq::mul(a, b); }

// a^(q - 2) = a^-1 in the Montgomery domain (aR -> a^-1 R, canonical for
// a canonical), left to right over the fixed exponent's bits: 253 squares
// and 109 products, the same branch on every thread.
ZKT_HD Fq pow_q_minus_2(const Fq& a) {
  static_assert(FqParams::P0 >= 2u && (FqParams::P7 >> 29) == 1u,
                "q - 2 borrows nothing and has its top bit at bit 253");
  const uint32_t e[NW] = {FqParams::P0 - 2u, FqParams::P1, FqParams::P2,
                          FqParams::P3,      FqParams::P4, FqParams::P5,
                          FqParams::P6,      FqParams::P7};
  Fq acc = a;  // bit 253
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
#pragma unroll 1
    for (int b = w == NW - 1 ? 28 : 31; b >= 0; --b) {
      acc = inv_mul(acc, acc);
      if ((e[w] >> b) & 1u) acc = inv_mul(acc, a);
    }
  }
  return acc;
}

// R mod q: one in the Montgomery domain, the stand-in of a zero lane.
ZKT_HD Fq fq_mont_one() {
  return {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu,
           0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
}

struct InvArgs {
  const int32_t* in[2];  // the lanes' (n, 16) planes: c0, and c1 over Fq2
  int32_t* out[2];       // the inverses' planes; out[0] holds the prefixes
};

// What inv_kernel inverts a lane through (its key: an Fq value, zero only
// for a zero lane) and how the lane's inverse follows from the key's.
template <class E>
struct InvLane;

// Over Fq the key is the lane's value.
template <>
struct InvLane<Fq> {
  static __device__ Fq key(const InvArgs& g, int64_t i) {
    return Fq::load(g.in[0] + i * 16);
  }
  static __device__ void stash(const InvArgs&, int64_t, const Fq&) {}
  static __device__ Fq again(const InvArgs& g, int64_t i) { return key(g, i); }
  static __device__ void finish(const InvArgs& g, int64_t i, const Fq& kinv) {
    kinv.store(g.out[0] + i * 16);
  }
};

// Over Fq2 the key is the norm a0^2 + a1^2, zero only for a = 0 (-1 is
// not a square mod q), kept in out[1] from the forward sweep to the back
// sweep; the inverse is (a0 n^-1, -(a1 n^-1)), fq2.py:inv's.
template <>
struct InvLane<Fq2> {
  static __device__ Fq key(const InvArgs& g, int64_t i) {
    const Fq a0 = Fq::load(g.in[0] + i * 16), a1 = Fq::load(g.in[1] + i * 16);
    return Fq::add(inv_mul(a0, a0), inv_mul(a1, a1));
  }
  static __device__ void stash(const InvArgs& g, int64_t i, const Fq& k) {
    k.store(g.out[1] + i * 16);
  }
  static __device__ Fq again(const InvArgs& g, int64_t i) {
    return Fq::load(g.out[1] + i * 16);
  }
  static __device__ void finish(const InvArgs& g, int64_t i, const Fq& kinv) {
    inv_mul(Fq::load(g.in[0] + i * 16), kinv).store(g.out[0] + i * 16);
    Fq::sub(Fq::zero(), inv_mul(Fq::load(g.in[1] + i * 16), kinv))
        .store(g.out[1] + i * 16);
  }
};

// Thread t of T = ceil(n / INV_PER_THREAD) inverts lanes t + j T < n.
template <class E>
__global__ void __launch_bounds__(INV_THREADS)
inv_kernel(const InvArgs g, int64_t n) {
  using Lane = InvLane<E>;
  const int64_t T = (n + INV_PER_THREAD - 1) / INV_PER_THREAD;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int cnt = int((n - 1 - t) / T) + 1;
  const Fq one = fq_mont_one();

  // forward: prefix_j = x_0 ... x_j, x_j the key or one, into out[0]
  Fq acc = one;
#pragma unroll 1
  for (int j = 0; j < cnt; ++j) {
    const int64_t i = t + j * T;
    const Fq k = Lane::key(g, i);
    Lane::stash(g, i, k);
    const Fq x = Fq::select(k.is_zero(), one, k);
    acc = j ? inv_mul(acc, x) : x;
    acc.store(g.out[0] + i * 16);
  }
  Fq inv = pow_q_minus_2(acc);  // (x_0 ... x_{cnt-1})^-1
  // back: inv is (x_0 ... x_j)^-1 on entry to step j
#pragma unroll 1
  for (int j = cnt - 1; j > 0; --j) {
    const int64_t i = t + j * T;
    const Fq k = Lane::again(g, i);
    const bool zero = k.is_zero();
    const Fq kinv = inv_mul(inv, Fq::load(g.out[0] + (i - T) * 16));
    inv = inv_mul(inv, Fq::select(zero, one, k));
    Lane::finish(g, i, Fq::select(zero, Fq::zero(), kinv));
  }
  Lane::finish(g, t, Fq::select(Lane::again(g, t).is_zero(), Fq::zero(), inv));
}

template <class E>
int launch_inv(const InvArgs& g, int64_t n, void* stream) {
  if (n > 0)
    inv_kernel<E><<<blocks_for((n + INV_PER_THREAD - 1) / INV_PER_THREAD,
                               INV_THREADS),
                    INV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g, n);
  return int(cudaGetLastError());
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

template <class F, bool SUB>
int launch_add_sub(const void* a, const void* b, int a_bcast, int b_bcast,
                   void* out, int64_t n, void* stream) {
  if (n <= 0) return int(cudaGetLastError());
  const unsigned grid = blocks_for(n, ADD_SUB_THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int32_t*>(a);
  const auto* y = static_cast<const int32_t*>(b);
  auto* o = static_cast<int32_t*>(out);
  const int64_t sa = a_bcast ? 0 : 16, sb = b_bcast ? 0 : 16;
  if constexpr (SUB)
    sub_kernel<F><<<grid, ADD_SUB_THREADS, 0, s>>>(x, y, sa, sb, o, n);
  else
    add_kernel<F><<<grid, ADD_SUB_THREADS, 0, s>>>(x, y, sa, sb, o, n);
  return int(cudaGetLastError());
}

}  // namespace zkt

extern "C" {

// (a +- b) mod p over n lanes of canonical operands; a_bcast / b_bcast: that
// operand is one row for every lane.
#define ZKT_ADD_SUB(NAME, F, SUB)                                            \
  int NAME(const void* a, const void* b, int a_bcast, int b_bcast,          \
           void* out, int64_t n, void* stream) {                            \
    return zkt::launch_add_sub<F, SUB>(a, b, a_bcast, b_bcast, out, n,      \
                                       stream);                             \
  }
ZKT_ADD_SUB(zkt_add_fr, zkt::Fr, false)
ZKT_ADD_SUB(zkt_sub_fr, zkt::Fr, true)
ZKT_ADD_SUB(zkt_add_fq, zkt::Fq, false)
ZKT_ADD_SUB(zkt_sub_fq, zkt::Fq, true)
#undef ZKT_ADD_SUB

int zkt_mont_mul_fr(const void* a, const void* b, const void* b_idx,
                    int b_bcast, void* out, int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fr>(a, b, b_idx, b_bcast, out, n, stream);
}

int zkt_mont_mul_fq(const void* a, const void* b, const void* b_idx,
                    int b_bcast, void* out, int64_t n, void* stream) {
  return zkt::launch_mont_mul<zkt::Fq>(a, b, b_idx, b_bcast, out, n, stream);
}

// a^-1 of n Fq lanes (0 -> 0), Montgomery form in and out.
int zkt_inv_fq(const void* a, void* out, int64_t n, void* stream) {
  const zkt::InvArgs g{{static_cast<const int32_t*>(a), nullptr},
                       {static_cast<int32_t*>(out), nullptr}};
  return zkt::launch_inv<zkt::Fq>(g, n, stream);
}

// a^-1 of n Fq2 lanes (a0, a1) -> (out0, out1) (0 -> 0).
int zkt_inv_fq2(const void* a0, const void* a1, void* out0, void* out1,
                int64_t n, void* stream) {
  const zkt::InvArgs g{
      {static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1)},
      {static_cast<int32_t*>(out0), static_cast<int32_t*>(out1)}};
  return zkt::launch_inv<zkt::Fq2>(g, n, stream);
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
