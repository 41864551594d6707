// BN254 Fr / Fq / Fq2 arithmetic for the zkrollup_torch CUDA kernels.
//
// Replaces the in-kernel field library of the Pallas kernels
// (zkrollup/fields/pallas_mont.py:_make_kernel and
// zkrollup/curve/pallas_curve.py:_k_mont_mul/_k_add/_k_sub, with the Fq2
// layer of zkrollup/curve/pallas_curve_g2.py:_k2_mul/_k2_sqr).
//
// Storage at every kernel boundary is the reference's: (n, 16) int32 rows of
// 16-bit limbs in Montgomery form with R = 2^256. In registers a value is
// 8 x 32-bit words; R stays 2^256, so Montgomery values are unchanged.
//
// What bounds it on the H100: 32-bit integer multiply issue (a CIOS product
// is 128 mad.lo/mad.hi pairs plus the carry chains) and register pressure.
// The design keeps the multiply in fully unrolled PTX carry chains
// (mad.lo.cc / madc.hi.cc), so no 64-bit emulation or carry tests in
// C++ sit on the critical path; every operation is branch-free.
//
// Fq2 here computes a whole G2 lane in one thread: the type of g2_add_nd.
// g2_add, g2_madd_nd, g2_madd, g2_double, g2_add_z01 and g2_horner use
// Fq2Pair (fq2_pair.cuh) instead, one lane on two threads, one
// Montgomery reduction an Fq2 product. g1_add, g1_madd_nd, g1_madd,
// g1_double and g1_horner use FqCall (fq_call.cuh): Fq with its product
// called, not inlined.
//
// Device code uses PTX; host compilers get a portable uint64 path with the
// same results, so the arithmetic can be checked without a GPU.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define ZKT_HD __host__ __device__ __forceinline__
#else
#define ZKT_HD inline
#endif

namespace zkt {

constexpr int NW = 8;  // 32-bit words per element

// BN254 scalar field r
struct FrParams {
  static constexpr uint32_t P0 = 0xf0000001u, P1 = 0x43e1f593u,
                            P2 = 0x79b97091u, P3 = 0x2833e848u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xefffffffu;  // -r^-1 mod 2^32
};

// BN254 base field q
struct FqParams {
  static constexpr uint32_t P0 = 0xd87cfd47u, P1 = 0x3c208c16u,
                            P2 = 0x6871ca8du, P3 = 0x97816a91u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xe4866389u;  // -q^-1 mod 2^32
};

template <class P>
struct Fp {
  uint32_t w[NW];

  ZKT_HD static void modulus(uint32_t p[NW]) {
    p[0] = P::P0; p[1] = P::P1; p[2] = P::P2; p[3] = P::P3;
    p[4] = P::P4; p[5] = P::P5; p[6] = P::P6; p[7] = P::P7;
  }

  ZKT_HD static Fp zero() {
    Fp r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = 0;
    return r;
  }

  // -- storage: 16 int32 limbs of 16 bits <-> 8 words ------------------------
  ZKT_HD static Fp load(const int32_t* row) {
    Fp r;
#ifdef __CUDA_ARCH__
    const int4* v = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int4 q = v[k];
      r.w[2 * k] = (uint32_t(q.x) & 0xffffu) | (uint32_t(q.y) << 16);
      r.w[2 * k + 1] = (uint32_t(q.z) & 0xffffu) | (uint32_t(q.w) << 16);
    }
#else
    for (int i = 0; i < NW; ++i)
      r.w[i] = (uint32_t(row[2 * i]) & 0xffffu) | (uint32_t(row[2 * i + 1]) << 16);
#endif
    return r;
  }

  ZKT_HD void store(int32_t* row) const {
#ifdef __CUDA_ARCH__
    int4* v = reinterpret_cast<int4*>(row);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int4 q;
      q.x = int32_t(w[2 * k] & 0xffffu);
      q.y = int32_t(w[2 * k] >> 16);
      q.z = int32_t(w[2 * k + 1] & 0xffffu);
      q.w = int32_t(w[2 * k + 1] >> 16);
      v[k] = q;
    }
#else
    for (int i = 0; i < NW; ++i) {
      row[2 * i] = int32_t(w[i] & 0xffffu);
      row[2 * i + 1] = int32_t(w[i] >> 16);
    }
#endif
  }

  ZKT_HD bool is_zero() const {
    uint32_t acc = w[0];
#pragma unroll
    for (int i = 1; i < NW; ++i) acc |= w[i];
    return acc == 0;
  }

  ZKT_HD static Fp select(bool c, const Fp& a, const Fp& b) {
    Fp r;
    uint32_t m = 0u - uint32_t(c);
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
    return r;
  }

  // -- a + b mod p: sum, trial subtraction, keep the difference on carry or
  //    no borrow (pallas_curve.py:_k_add) -------------------------------------
  ZKT_HD static Fp add(const Fp& a, const Fp& b) {
    uint32_t p[NW];
    modulus(p);
    uint32_t s[NW], d[NW], carry, borrow;
#ifdef __CUDA_ARCH__
    asm("add.cc.u32 %0, %9, %17;\n\t"
        "addc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\t"
        "addc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\t"
        "addc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\t"
        "addc.cc.u32 %7, %16, %24;\n\t"
        "addc.u32 %8, 0, 0;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
          "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(carry)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]));
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
        : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]),
          "r"(s[6]), "r"(s[7]), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]),
          "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
    borrow &= 1u;
#else
    uint64_t c = 0;
    for (int i = 0; i < NW; ++i) {
      c += uint64_t(a.w[i]) + b.w[i];
      s[i] = uint32_t(c);
      c >>= 32;
    }
    carry = uint32_t(c);
    uint64_t br = 0;
    for (int i = 0; i < NW; ++i) {
      uint64_t v = uint64_t(s[i]) - p[i] - br;
      d[i] = uint32_t(v);
      br = (v >> 63) & 1u;
    }
    borrow = uint32_t(br);
#endif
    bool take_d = (carry != 0) || (borrow == 0);
    Fp r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = take_d ? d[i] : s[i];
    return r;
  }

  // -- a - b mod p: difference, add p back on borrow (pallas_curve.py:_k_sub)
  ZKT_HD static Fp sub(const Fp& a, const Fp& b) {
    uint32_t p[NW];
    modulus(p);
    uint32_t d[NW], bw;
#ifdef __CUDA_ARCH__
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(bw)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]));
    // bw is 0 or 0xffffffff: add p masked by the borrow
    Fp r;
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, %23;"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
          "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
        : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
          "r"(d[6]), "r"(d[7]), "r"(p[0] & bw), "r"(p[1] & bw),
          "r"(p[2] & bw), "r"(p[3] & bw), "r"(p[4] & bw), "r"(p[5] & bw),
          "r"(p[6] & bw), "r"(p[7] & bw));
    return r;
#else
    uint64_t br = 0;
    for (int i = 0; i < NW; ++i) {
      uint64_t v = uint64_t(a.w[i]) - b.w[i] - br;
      d[i] = uint32_t(v);
      br = (v >> 63) & 1u;
    }
    bw = 0u - uint32_t(br);
    Fp r;
    uint64_t c = 0;
    for (int i = 0; i < NW; ++i) {
      c += uint64_t(d[i]) + (p[i] & bw);
      r.w[i] = uint32_t(c);
      c >>= 32;
    }
    return r;
#endif
  }

  ZKT_HD static Fp dbl(const Fp& a) { return add(a, a); }

  // -- CIOS Montgomery product a*b*2^-256 mod p --------------------------------
  // Inputs a < 2^256 and b < p give a result below 2p before the one
  // conditional subtraction (the lazy inputs of the spmv fold rely on it),
  // the same contract as pallas_mont.py:_make_kernel.
  ZKT_HD static Fp mul(const Fp& a, const Fp& b) {
    uint32_t p[NW];
    modulus(p);
    uint32_t t[NW + 2];
#pragma unroll
    for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#ifdef __CUDA_ARCH__
    const uint32_t inv = P::INV;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t bi = b.w[i];
      // t += a * b_i  (low halves into t[j], high halves into t[j+1])
      asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
          "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
          "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
          "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
          "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
          "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
          "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
          "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
          "addc.cc.u32 %8, %8, 0;\n\t"
          "addc.u32 %9, %9, 0;\n\t"
          "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
          "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
          "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
          "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
          "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
          "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
          "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
          "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
          "addc.u32 %9, %9, 0;"
          : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
            "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
          : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
            "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(bi));
      // m = t0 * (-p^-1); t += m * p  (t0 becomes 0)
      uint32_t m;
      asm("mul.lo.u32 %10, %0, %19;\n\t"
          "mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
          "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
          "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
          "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
          "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
          "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
          "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
          "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
          "addc.cc.u32 %8, %8, 0;\n\t"
          "addc.u32 %9, %9, 0;\n\t"
          "mad.hi.cc.u32 %1, %10, %11, %1;\n\t"
          "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
          "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
          "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
          "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
          "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
          "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
          "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
          "addc.u32 %9, %9, 0;"
          : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
            "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
            "=&r"(m)
          : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]),
            "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(inv));
      // shift down one word
#pragma unroll
      for (int j = 0; j < NW + 1; ++j) t[j] = t[j + 1];
      t[NW + 1] = 0;
    }
    // conditional subtraction over 9 words (t < 2p, t[8] in {0, 1})
    uint32_t d[NW], hi;
    asm("sub.cc.u32 %0, %9, %18;\n\t"
        "subc.cc.u32 %1, %10, %19;\n\t"
        "subc.cc.u32 %2, %11, %20;\n\t"
        "subc.cc.u32 %3, %12, %21;\n\t"
        "subc.cc.u32 %4, %13, %22;\n\t"
        "subc.cc.u32 %5, %14, %23;\n\t"
        "subc.cc.u32 %6, %15, %24;\n\t"
        "subc.cc.u32 %7, %16, %25;\n\t"
        "subc.u32 %8, %17, 0;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(hi)
        : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
          "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(p[0]), "r"(p[1]), "r"(p[2]),
          "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
    const bool keep_t = (hi == 0xffffffffu);
#else
    for (int i = 0; i < NW; ++i) {
      uint64_t c = 0;
      for (int j = 0; j < NW; ++j) {
        c += uint64_t(t[j]) + uint64_t(a.w[j]) * b.w[i];
        t[j] = uint32_t(c);
        c >>= 32;
      }
      c += t[NW];
      t[NW] = uint32_t(c);
      t[NW + 1] = uint32_t(c >> 32);
      const uint32_t m = t[0] * P::INV;
      c = uint64_t(t[0]) + uint64_t(m) * p[0];
      c >>= 32;
      for (int j = 1; j < NW; ++j) {
        c += uint64_t(t[j]) + uint64_t(m) * p[j];
        t[j - 1] = uint32_t(c);
        c >>= 32;
      }
      c += t[NW];
      t[NW - 1] = uint32_t(c);
      t[NW] = t[NW + 1] + uint32_t(c >> 32);
      t[NW + 1] = 0;
    }
    uint32_t d[NW];
    uint64_t br = 0;
    for (int i = 0; i < NW; ++i) {
      uint64_t v = uint64_t(t[i]) - p[i] - br;
      d[i] = uint32_t(v);
      br = (v >> 63) & 1u;
    }
    const bool keep_t = (t[NW] < br);
#endif
    Fp r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = keep_t ? t[i] : d[i];
    return r;
  }

  ZKT_HD static Fp sqr(const Fp& a) { return mul(a, a); }
};

using Fr = Fp<FrParams>;
using Fq = Fp<FqParams>;

// Fq2 = Fq[u]/(u^2 + 1): Karatsuba multiply in 3 base products, square in 2
// (pallas_curve_g2.py:_k2_mul/_k2_sqr).
struct Fq2 {
  Fq c0, c1;

  ZKT_HD static Fq2 add(const Fq2& a, const Fq2& b) {
    return {Fq::add(a.c0, b.c0), Fq::add(a.c1, b.c1)};
  }
  ZKT_HD static Fq2 sub(const Fq2& a, const Fq2& b) {
    return {Fq::sub(a.c0, b.c0), Fq::sub(a.c1, b.c1)};
  }
  ZKT_HD static Fq2 dbl(const Fq2& a) { return {Fq::dbl(a.c0), Fq::dbl(a.c1)}; }
  ZKT_HD static Fq2 mul(const Fq2& a, const Fq2& b) {
    Fq t0 = Fq::mul(a.c0, b.c0);
    Fq t1 = Fq::mul(a.c1, b.c1);
    Fq t2 = Fq::mul(Fq::add(a.c0, a.c1), Fq::add(b.c0, b.c1));
    return {Fq::sub(t0, t1), Fq::sub(Fq::sub(t2, t0), t1)};
  }
  ZKT_HD static Fq2 sqr(const Fq2& a) {
    Fq re = Fq::mul(Fq::add(a.c0, a.c1), Fq::sub(a.c0, a.c1));
    Fq im = Fq::dbl(Fq::mul(a.c0, a.c1));
    return {re, im};
  }
  ZKT_HD bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
  ZKT_HD static Fq2 select(bool c, const Fq2& a, const Fq2& b) {
    return {Fq::select(c, a.c0, b.c0), Fq::select(c, a.c1, b.c1)};
  }
  ZKT_HD static Fq2 zero() { return {Fq::zero(), Fq::zero()}; }
};

// Coordinate storage: one (n, 16) plane per Fq coordinate, two per Fq2.
template <class E> struct Planes;
template <> struct Planes<Fq> {
  static constexpr int K = 1;
  ZKT_HD static Fq load(const int32_t* const* pl, int64_t i) {
    return Fq::load(pl[0] + i * 16);
  }
  ZKT_HD static void store(int32_t* const* pl, int64_t i, const Fq& v) {
    v.store(pl[0] + i * 16);
  }
};
template <> struct Planes<Fq2> {
  static constexpr int K = 2;
  ZKT_HD static Fq2 load(const int32_t* const* pl, int64_t i) {
    return {Fq::load(pl[0] + i * 16), Fq::load(pl[1] + i * 16)};
  }
  ZKT_HD static void store(int32_t* const* pl, int64_t i, const Fq2& v) {
    v.c0.store(pl[0] + i * 16);
    v.c1.store(pl[1] + i * 16);
  }
};

}  // namespace zkt
