// FqCall: Fq with its product as a called function, not inlined, for the
// G1 point kernels of the prove path (g1_add and g1_madd_nd), of the
// setup's fixed-base steps (g1_madd) and of the MSM's Horner (g1_double,
// g1_horner), g1.cu.
//
// Replaces, for those three kernels, the in-kernel field library of
// zkrollup/curve/pallas_curve.py (_k_mont_mul, _k_sqr) that Fq in
// field.cuh follows inlined.
//
// Fq's product is __forceinline__: a G1 add inlines 23 copies of a CIOS
// body of about 300 instructions, a mixed add 11. Called, a kernel holds
// one copy; each call costs a few moves of its 16 argument and 8 result
// registers. On the H100 (chip_smoke.py --ab against the same kernels
// with the product inlined, same launch bounds) that made g1_add 1.8x
// faster at the (2,6) proof's widths and 1.7x on one lane, g1_madd_nd
// 1.08x at its proof width (1.1x slower on one lane, a width it is never
// launched at), with fewer registers: 149 and 124 against 156 and 126.
//
// Values, storage and results are Fq's: mul runs Fp::mul's body, and
// every other operation forwards to Fq, so the two types agree bit for
// bit. g1.cu's g1_add, g1_madd_nd, g1_madd, g1_double and g1_horner are
// instantiated over it (g1_madd since it moved off Fq: 3.1x at the
// setup's 482,413 lanes, chip_smoke.py --ab, with the doubling path voted
// per warp; g1_double and g1_horner: g1.cu); g1_add_nd and g1_add_z01
// keep Fq.
#pragma once

#include <cstdint>

#include "curve.cuh"
#include "field.cuh"

#ifdef __CUDACC__
#define ZKT_CALLED __host__ __device__ __noinline__
#else
#define ZKT_CALLED inline
#endif

namespace zkt {

struct FqCall {
  Fq v;

  ZKT_HD static FqCall zero() { return {Fq::zero()}; }
  ZKT_HD static FqCall add(const FqCall& a, const FqCall& b) {
    return {Fq::add(a.v, b.v)};
  }
  ZKT_HD static FqCall sub(const FqCall& a, const FqCall& b) {
    return {Fq::sub(a.v, b.v)};
  }
  ZKT_HD static FqCall dbl(const FqCall& a) { return {Fq::dbl(a.v)}; }
  ZKT_HD static FqCall select(bool c, const FqCall& a, const FqCall& b) {
    return {Fq::select(c, a.v, b.v)};
  }
  ZKT_HD bool is_zero() const { return v.is_zero(); }

  // The operands by value, as Fq2Pair::mul takes them: no address of a
  // caller's register is taken, so no value goes to the stack.
  ZKT_CALLED static FqCall mul(FqCall a, FqCall b) {
    return {Fq::mul(a.v, b.v)};
  }
  ZKT_HD static FqCall sqr(const FqCall& a) { return mul(a, a); }
};

template <>
struct Planes<FqCall> {
  static constexpr int K = 1;
  ZKT_HD static FqCall load(const int32_t* const* pl, int64_t i) {
    return {Fq::load(pl[0] + i * 16)};
  }
  ZKT_HD static void store(int32_t* const* pl, int64_t i, const FqCall& v) {
    v.v.store(pl[0] + i * 16);
  }
};

// g1_add over this type runs the doubling path only in warps where some
// lane needs it (jac_add_lane); the mixed add votes over every type
// (jac_madd_lane).
template <>
struct VoteDoubling<FqCall> {
  static constexpr bool value = true;
};

}  // namespace zkt
