// Fq2Pair: an Fq2 value of one G2 lane spread over two adjacent threads of
// a warp (lanes 2j and 2j+1), for the paired point kernels of points.cuh
// (jac_add, jac_madd_nd, jac_madd, jac_double and jac_add_z01 over Fq2:
// g2_add, g2_madd_nd, g2_madd, g2_double and g2_add_z01) and the G2
// Horner (g2_horner: every pair of its one warp on the same chain).
//
// Replaces, for those kernels, the Fq2 layer of
// zkrollup/curve/pallas_curve_g2.py (_k2_mul, _k2_sqr) that Fq2 in
// field.cuh follows one thread a lane.
//
// What bounds the one-thread Fq2 point kernels on the H100 is latency and
// occupancy as much as the 32-bit multiply rate: one thread holds 16
// registers a value, so jac_add<Fq2> and jac_madd_nd<Fq2> reach 255
// registers and spill (an SM then holds 8 warps), and each Fq2 product is
// three CIOS products in one long dependent carry chain. Here thread k
// (k = threadIdx.x & 1) holds component ck of every value: 8 registers a
// value, and each thread's chain is half the lane's.
//
//   add, sub, dbl, select, zero  componentwise, no exchange
//   is_zero  ORs the two halves through one shuffle, so both threads of a
//            pair always take the same selects
//   mul      fetches the partner's components of a and b (16 shuffles);
//            then thread 0 computes c0 = a0 b0 - a1 b1 as
//            T = a0 b0 + a1 (q - b1) and thread 1 c1 = a0 b1 + a1 b0 as
//            T = a1 b0 + a0 b1: two 256 x 256-bit products summed without
//            reduction, ONE word-by-word Montgomery reduction of the sum
//            and one conditional subtraction. The a1 q offset is a
//            multiple of q that keeps T >= 0 (it stands where a q^2 offset
//            would, with one 256-bit operand negated instead of a 512-bit
//            product). The products and the reduction are interleaved
//            CIOS-style in a 9-word window: m_i depends only on word i of
//            T, so the m words, and the result, are those of REDC(T).
//   sqr      thread 0 computes (a0 + a1)(a0 - a1), thread 1 2 a0 a1: one
//            CIOS product each (Fp::mul, unchanged)
//
// The contract: every operand of mul is canonical (< q). Then T < 2 q^2 <
// q 2^256, REDC(T) < 2q and one subtraction gives the canonical value,
// which is the value Fq2::mul's Karatsuba gives (every step there is
// canonical too), so the two agree bit for bit. It holds in the point
// formulas: the tables hold canonical values and every field op returns
// one. Fp::mul's lazier contract (a < 2^256) stays for the spmv path,
// which does not use this type.
//
// Per thread a product is 2 x 128 multiply instructions for the two
// products and 8 x 17 for the reduction, against 3 x 264 in one thread
// for Fq2::mul: about the same per lane, half the chain per thread, and 8
// registers a value instead of 16, so the paired kernels run 12
// warps an SM with no spill (g2.cu).
//
// Device only: the two halves of a value live in two threads. Every
// thread of a warp must reach every shuffle, so a kernel on this type
// computes on every thread (a ragged edge clamps its lane index) and
// predicates only the store.
#pragma once

#include <cstdint>

#include "field.cuh"

#ifdef __CUDACC__

namespace zkt {

// 0 on the thread that holds c0 of its lane's values, 1 on the c1 thread.
__device__ __forceinline__ uint32_t pair_half() { return threadIdx.x & 1u; }

// The partner thread's copy of v.
__device__ __forceinline__ uint32_t pair_swap(uint32_t v) {
  return __shfl_xor_sync(0xffffffffu, v, 1);
}

// t[0..8] += a * b: the low halves into t[0..7] with the carry into t[8],
// the high halves into t[1..8]. No carry leaves t[8]: the callers keep
// the window below 2^288.
__device__ __forceinline__ void mac_row9(uint32_t t[NW + 1],
                                         const uint32_t a[NW], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// One reduction step: m = t0 (-q^-1) mod 2^32, t += m q (t0 becomes 0),
// then the window moves down one word.
__device__ __forceinline__ void redc_step9(uint32_t t[NW + 1],
                                           const uint32_t q[NW]) {
  const uint32_t inv = FqParams::INV;
  uint32_t m;
  asm("mul.lo.u32 %9, %0, %18;\n\t"
      "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32 %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=&r"(m)
      : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]),
        "r"(q[6]), "r"(q[7]), "r"(inv));
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
  t[NW] = 0;
}

// mul is one function the kernel calls, not inlined: a point add makes 12
// to 16 products, and inlined copies of ~480 instructions each made
// jac_add_pair need 242 registers for no spill (8 warps an SM) and double
// its one-lane latency; called, it fits 168 registers (12 warps) with no
// stack frame.

struct Fq2Pair {
  Fq c;  // this thread's component: c0 on the even thread, c1 on the odd

  __device__ __forceinline__ static Fq2Pair add(const Fq2Pair& a,
                                                const Fq2Pair& b) {
    return {Fq::add(a.c, b.c)};
  }
  __device__ __forceinline__ static Fq2Pair sub(const Fq2Pair& a,
                                                const Fq2Pair& b) {
    return {Fq::sub(a.c, b.c)};
  }
  __device__ __forceinline__ static Fq2Pair dbl(const Fq2Pair& a) {
    return {Fq::dbl(a.c)};
  }
  __device__ __forceinline__ static Fq2Pair zero() { return {Fq::zero()}; }
  __device__ __forceinline__ static Fq2Pair select(bool cond,
                                                   const Fq2Pair& a,
                                                   const Fq2Pair& b) {
    return {Fq::select(cond, a.c, b.c)};
  }
  __device__ __forceinline__ bool is_zero() const {
    uint32_t acc = c.w[0];
#pragma unroll
    for (int i = 1; i < NW; ++i) acc |= c.w[i];
    return (acc | pair_swap(acc)) == 0;
  }

  // (a0 + a1 u)(b0 + b1 u): T = x_a B1 + y_a B2 with x_a, y_a this
  // thread's and the partner's component of a, and
  //   c0 thread: B1 = b0, B2 = q - b1  (T = a0 b0 + a1 (q - b1))
  //   c1 thread: B1 = b0, B2 = b1      (T = a1 b0 + a0 b1)
  // Step i takes word i of B1 and B2: the partner's word of b comes by
  // one shuffle a step and q - b1 is formed word by word with its borrow,
  // so only y_a and the window stay live beside the operands. The window
  // stays below 2^288: it enters each step below 2^256 and gains three
  // terms below 2^286.
  __device__ __noinline__ static Fq2Pair mul(Fq2Pair a, Fq2Pair b) {
    const bool odd = pair_half() != 0;
    Fq q, ya;
    Fq::modulus(q.w);
#pragma unroll
    for (int i = 0; i < NW; ++i) ya.w[i] = pair_swap(a.c.w[i]);
    uint32_t t[NW + 1];
#pragma unroll
    for (int i = 0; i < NW + 1; ++i) t[i] = 0;
    uint32_t borrow = 0;  // of q - yb below word i; yb < q, none leaves
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t yb = pair_swap(b.c.w[i]);
      const uint64_t nb = uint64_t(q.w[i]) - yb - borrow;
      borrow = uint32_t(nb >> 63);
      mac_row9(t, a.c.w, odd ? yb : b.c.w[i]);
      mac_row9(t, ya.w, odd ? b.c.w[i] : uint32_t(nb));
      redc_step9(t, q.w);
    }
    // t < 2q (t[8] == 0): one conditional subtraction
    Fq r, d;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = t[i];
    uint32_t below;  // all ones where t < q
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
          "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]),
          "=r"(below)
        : "r"(r.w[0]), "r"(r.w[1]), "r"(r.w[2]), "r"(r.w[3]), "r"(r.w[4]),
          "r"(r.w[5]), "r"(r.w[6]), "r"(r.w[7]), "r"(q.w[0]), "r"(q.w[1]),
          "r"(q.w[2]), "r"(q.w[3]), "r"(q.w[4]), "r"(q.w[5]), "r"(q.w[6]),
          "r"(q.w[7]));
    return {Fq::select(below != 0, r, d)};
  }

  // (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: one product a thread,
  // the operands in Fq2::sqr's order.
  __device__ __forceinline__ static Fq2Pair sqr(const Fq2Pair& a) {
    const bool odd = pair_half() != 0;
    Fq y;
#pragma unroll
    for (int i = 0; i < NW; ++i) y.w[i] = pair_swap(a.c.w[i]);
    // c0 thread: x = a0, y = a1; c1 thread: x = a1, y = a0
    const Fq u = Fq::select(odd, y, Fq::add(a.c, y));
    const Fq v = Fq::select(odd, a.c, Fq::sub(a.c, y));
    const Fq r = Fq::mul(u, v);
    return {Fq::select(odd, Fq::dbl(r), r)};
  }
};

// Each thread loads and stores its own plane of a coordinate; the storage
// is Fq2's, (n, 16) int32 rows of 16-bit limbs, two planes a coordinate.
template <>
struct Planes<Fq2Pair> {
  static constexpr int K = 2;
  __device__ __forceinline__ static Fq2Pair load(const int32_t* const* pl,
                                                 int64_t i) {
    return {Fq::load((pair_half() ? pl[1] : pl[0]) + i * 16)};
  }
  __device__ __forceinline__ static void store(int32_t* const* pl, int64_t i,
                                               const Fq2Pair& v) {
    v.c.store((pair_half() ? pl[1] : pl[0]) + i * 16);
  }
};

}  // namespace zkt

#endif  // __CUDACC__
