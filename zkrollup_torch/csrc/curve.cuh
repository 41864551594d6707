// Jacobian point formulas over Fq (G1) or Fq2 (G2) for the zkrollup_torch
// CUDA kernels: one lane = one point (double) or one point pair (adds),
// branch-free but for the warp votes of the doubling path: the add's over
// FqCall (jac_add_lane) and in the Horner (horner_lane), the z01 add's
// (jac_add_z01_voted_lane) and the mixed add's (jac_madd_lane) over every
// type.
//
// Replace the point kernels of zkrollup/curve/pallas_curve.py (_add_kernel,
// _add_nd_kernel, _add_z01_kernel, _make_madd_kernel(False),
// _make_madd_kernel(True), _double_kernel) and their Fq2 instantiations in
// zkrollup/curve/pallas_curve_g2.py (_make_add_kernel(False/True),
// _make_madd_kernel, _double_kernel); horner_lane replaces the device
// Horner of zkrollup/msm/msm.py:msm, a loop over those double and add
// kernels on one point. The add tail (add_xy), the Jacobian
// add path, the doubling formula (dbl_xy), the unified add (jac_add) and
// the closing selects (inf_selects) are each written once and shared, so
// the kernels cannot drift apart. The lane functions are host/device so
// the formulas compile for a CPU as well as for the GPU.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace zkt {

struct PointArgs {
  const int32_t* in[12];  // X1 Y1 Z1 X2 Y2 Z2 (a double reads the first
                          // three), K planes each
  int32_t* out[6];        // X3 Y3 Z3, K planes each
};

// Store one lane's result X3 Y3 Z3, unless the lane is not live (a thread
// past the ragged edge of a paired kernel or of g1_add, which computes on
// a clamped lane so that every thread reaches the shuffles or the warp
// vote, and stores nothing).
template <class E>
ZKT_HD void store3(const PointArgs& args, int64_t i, bool live, const E& X3,
                   const E& Y3, const E& Z3) {
  if (!live) return;
  using P = Planes<E>;
  constexpr int K = P::K;
  P::store(args.out + 0 * K, i, X3);
  P::store(args.out + 1 * K, i, Y3);
  P::store(args.out + 2 * K, i, Z3);
}

// X3 and Y3 of dbl-2007-bl for a = 0 (pallas_curve.py:_k_double_point):
// 5 squares and 1 product. They do not depend on Z.
template <class E>
ZKT_HD void dbl_xy(E& X3, E& Y3, const E& X, const E& Y) {
  E A = E::sqr(X);
  E B = E::sqr(Y);
  E C = E::sqr(B);
  E t = E::sqr(E::add(X, B));
  E D = E::dbl(E::sub(E::sub(t, A), C));
  E Ee = E::add(E::dbl(A), A);
  E F2 = E::sqr(Ee);
  X3 = E::sub(F2, E::dbl(D));
  E C8 = E::dbl(E::dbl(E::dbl(C)));
  Y3 = E::sub(E::mul(Ee, E::sub(D, X3)), C8);
}

// dbl-2007-bl for a = 0: Z3 = 2 Y Z, so doubling infinity (Z = 0) keeps
// Z3 = 0 (pallas_curve.py:_double_kernel).
template <class E>
ZKT_HD void jac_double(E& X3, E& Y3, E& Z3, const E& X, const E& Y,
                       const E& Z) {
  dbl_xy(X3, Y3, X, Y);
  Z3 = E::mul(E::dbl(Y), Z);
}

// One lane of the double kernel: in X Y Z, out X3 Y3 Z3.
template <class E>
ZKT_HD void jac_double_lane(const PointArgs& args, int64_t i,
                            bool live = true) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X = P::load(args.in + 0 * K, i), Y = P::load(args.in + 1 * K, i),
          Z = P::load(args.in + 2 * K, i);
  E X3, Y3, Z3;
  jac_double(X3, Y3, Z3, X, Y, Z);
  store3(args, i, live, X3, Y3, Z3);
}

// The tail every add shares: from H = U2 - U1 and R = S2 - S1,
// X3 = R^2 - H^3 - 2 U1 H^2 and Y3 = R (U1 H^2 - X3) - S1 H^3
// (4 products, 2 squares).
template <class E>
ZKT_HD void add_xy(E& X3, E& Y3, const E& H, const E& R, const E& U1,
                   const E& S1) {
  E HH = E::sqr(H);
  E HHH = E::mul(H, HH);
  E V = E::mul(U1, HH);
  X3 = E::sub(E::sub(E::sqr(R), HHH), E::dbl(V));
  Y3 = E::sub(E::mul(R, E::sub(V, X3)), E::mul(S1, HHH));
}

// The add-2007-bl add path of P + Q, both Jacobian: 12 products and 4
// squares. H = R = 0 when P == Q; H = 0, R != 0 when P == -Q. Shared by the
// unified add and the add without the doubling path.
template <class E>
ZKT_HD void jac_add_path(E& X3, E& Y3, E& Z3, E& H, E& R, const E& X1,
                         const E& Y1, const E& Z1, const E& X2, const E& Y2,
                         const E& Z2) {
  E Z1Z1 = E::sqr(Z1);
  E Z2Z2 = E::sqr(Z2);
  E U1 = E::mul(X1, Z2Z2);
  E U2 = E::mul(X2, Z1Z1);
  E S1 = E::mul(E::mul(Y1, Z2), Z2Z2);
  E S2 = E::mul(E::mul(Y2, Z1), Z1Z1);
  H = E::sub(U2, U1);
  R = E::sub(S2, S1);
  add_xy(X3, Y3, H, R, U1, S1);
  Z3 = E::mul(E::mul(Z1, Z2), H);
}

// The selects every add ends with, in the Pallas kernels' order: where
// to_inf (P + (-P)) only Z is zeroed; infinity on either side (Z = 0)
// gives the other operand.
template <class E>
ZKT_HD void inf_selects(E& X3, E& Y3, E& Z3, bool to_inf, bool p_inf,
                        bool q_inf, const E& X1, const E& Y1, const E& Z1,
                        const E& X2, const E& Y2, const E& Z2) {
  Z3 = E::select(to_inf, E::zero(), Z3);
  X3 = E::select(p_inf, X2, X3);
  Y3 = E::select(p_inf, Y2, Y3);
  Z3 = E::select(p_inf, Z2, Z3);
  X3 = E::select(q_inf, X1, X3);
  Y3 = E::select(q_inf, Y1, Y3);
  Z3 = E::select(q_inf, Z1, Z3);
}

// Whether jac_add_lane over E runs the doubling path only in warps where
// some lane needs it (true for FqCall, fq_call.cuh: g1_add). Over every
// other type each lane computes it, branch-free. jac_madd_lane votes over
// every type and does not read this.
template <class E>
struct VoteDoubling {
  static constexpr bool value = false;
};

// True on every thread of a warp where `need` holds on any of them. Every
// thread of the warp must reach the vote: a kernel that calls it clamps
// its lane index past the ragged edge and stores nothing there. A host
// build is one lane a warp.
ZKT_HD bool any_in_warp(bool need) {
#ifdef __CUDA_ARCH__
  return __any_sync(0xffffffffu, need);
#else
  return need;
#endif
}

// Unified Jacobian add with the doubling path and the infinity and P + (-P)
// masks (pallas_curve.py:_add_kernel), in registers: the add path, the
// doubling path, then the selects. Infinity is Z = 0; on P + (-P) only Z
// is zeroed, as in the Pallas kernel. X3 Y3 Z3 must not alias an operand.
//
// The doubling's result survives the selects only where H = R = 0 with
// neither operand infinite: where either is, the infinity selects
// overwrite all three coordinates (infinity + infinity also has
// H = R = 0). With VOTE a warp computes the doubling and its selects only
// if one of its lanes is such a lane; every lane's result is the same as
// when every lane computes it. Every thread of the warp must reach the
// vote.
template <class E, bool VOTE = VoteDoubling<E>::value>
ZKT_HD void jac_add(E& X3, E& Y3, E& Z3, const E& X1, const E& Y1,
                    const E& Z1, const E& X2, const E& Y2, const E& Z2) {
  E H, R;
  jac_add_path(X3, Y3, Z3, H, R, X1, Y1, Z1, X2, Y2, Z2);

  const bool h_zero = H.is_zero(), r_zero = R.is_zero();
  const bool p_inf = Z1.is_zero(), q_inf = Z2.is_zero();
  const bool same = h_zero && r_zero;
  bool doubling = true;
  if constexpr (VOTE) doubling = any_in_warp(same && !p_inf && !q_inf);
  if (doubling) {
    E dX, dY, dZ;
    jac_double(dX, dY, dZ, X1, Y1, Z1);
    X3 = E::select(same, dX, X3);
    Y3 = E::select(same, dY, Y3);
    Z3 = E::select(same, dZ, Z3);
  }
  const bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  inf_selects(X3, Y3, Z3, to_inf, p_inf, q_inf, X1, Y1, Z1, X2, Y2, Z2);
}

// One lane of the unified add: load, jac_add (voted over a VoteDoubling
// type), store.
template <class E>
ZKT_HD void jac_add_lane(const PointArgs& args, int64_t i,
                         bool live = true) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X1 = P::load(args.in + 0 * K, i), Y1 = P::load(args.in + 1 * K, i),
          Z1 = P::load(args.in + 2 * K, i);
  const E X2 = P::load(args.in + 3 * K, i), Y2 = P::load(args.in + 4 * K, i),
          Z2 = P::load(args.in + 5 * K, i);
  E X3, Y3, Z3;
  jac_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  store3(args, i, live, X3, Y3, Z3);
}

// The MSM's Horner combine over the window sums (zkrollup/msm/msm.py:msm,
// a fori_loop of curve.double and curve.add): args.in holds the X Y Z
// planes of W rows, W_0 .. W_{W-1}. From res = infinity (every word 0),
// for w = W-1 .. 0: c doubles of res, then res = res + W_w (the unified
// add, its operands in that order). res is stored once, at row 0 of out,
// if `live`.
//
// Every value carried in registers from one step to the next is the
// canonical value that the route of one double or add launch a step
// stored and reloaded, through the same operations in the same order, so
// the limbs are that route's. The add's doubling path is voted over every
// type: the kernels run the chain on one warp whose threads all hold the
// same point (or the same pair of halves), so the vote is uniform and the
// path is computed only where res == W_w.
template <class E>
ZKT_HD void horner_lane(const PointArgs& args, int64_t W, int c, bool live) {
  using P = Planes<E>;
  constexpr int K = P::K;
  E X = E::zero(), Y = E::zero(), Z = E::zero();
#pragma unroll 1
  for (int64_t w = W - 1; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < c; ++k) {
      E dX, dY, dZ;
      jac_double(dX, dY, dZ, X, Y, Z);
      X = dX;
      Y = dY;
      Z = dZ;
    }
    const E X2 = P::load(args.in + 0 * K, w),
            Y2 = P::load(args.in + 1 * K, w),
            Z2 = P::load(args.in + 2 * K, w);
    E aX, aY, aZ;
    jac_add<E, true>(aX, aY, aZ, X, Y, Z, X2, Y2, Z2);
    X = aX;
    Y = aY;
    Z = aZ;
  }
  store3(args, 0, live, X, Y, Z);
}

// Jacobian add WITHOUT the doubling path (pallas_curve.py:_add_nd_kernel,
// pallas_curve_g2.py:_make_add_kernel(distinct=True)): the add path of
// jac_add_lane, then P + (-P) -> infinity (Z only) wherever H = 0 with
// neither operand infinite, then the infinity selects. Wrong when P == Q
// (H = R = 0: Z3 = 0 there too): callers use it only where the operands
// are distinct points. A lane that is not `live` (past the ragged edge of
// g2.cu's paired kernel) stores nothing.
template <class E>
ZKT_HD void jac_add_nd_lane(const PointArgs& args, int64_t i,
                            bool live = true) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X1 = P::load(args.in + 0 * K, i), Y1 = P::load(args.in + 1 * K, i),
          Z1 = P::load(args.in + 2 * K, i);
  const E X2 = P::load(args.in + 3 * K, i), Y2 = P::load(args.in + 4 * K, i),
          Z2 = P::load(args.in + 5 * K, i);
  E X3, Y3, Z3, H, R;
  jac_add_path(X3, Y3, Z3, H, R, X1, Y1, Z1, X2, Y2, Z2);

  const bool p_inf = Z1.is_zero(), q_inf = Z2.is_zero();
  const bool to_inf = H.is_zero() && !p_inf && !q_inf;
  inf_selects(X3, Y3, Z3, to_inf, p_inf, q_inf, X1, Y1, Z1, X2, Y2, Z2);
  store3(args, i, live, X3, Y3, Z3);
}

// Unified add for operands whose Z is 0 or 1 EXACTLY (affine points or
// infinity), as
// pallas_curve.py:_add_z01_kernel: the add path with U1 = X1, S1 = Y1,
// U2 = X2, S2 = Y2 and Z3 = H (4 products, 2 squares); the affine double
// (mdbl) of P through dbl_xy with Z3 = 2 Y1 (1 product, 5 squares); then
// the selects in the kernel's order. A Z other than 0 or the Montgomery
// one gives a wrong result. A warp computes the double and its selects
// only if one of its lanes has H = R = 0 with neither operand infinite
// (jac_add's rule; every lane's result is the same as when every lane
// computes it), so every thread of the warp must reach the vote: both
// kernels on this lane (g1.cu's g1_add_z01_kernel over FqCall, g2.cu's
// jac_add_z01_pair_kernel over Fq2Pair) launch whole warps and clamp
// their lane index past the ragged edge, where `live` is false.
template <class E>
ZKT_HD void jac_add_z01_voted_lane(const PointArgs& args, int64_t i,
                                   bool live) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X1 = P::load(args.in + 0 * K, i), Y1 = P::load(args.in + 1 * K, i),
          Z1 = P::load(args.in + 2 * K, i);
  const E X2 = P::load(args.in + 3 * K, i), Y2 = P::load(args.in + 4 * K, i),
          Z2 = P::load(args.in + 5 * K, i);
  const E H = E::sub(X2, X1);
  const E R = E::sub(Y2, Y1);
  E X3, Y3;
  add_xy(X3, Y3, H, R, X1, Y1);
  E Z3 = H;

  const bool h_zero = H.is_zero(), r_zero = R.is_zero();
  const bool p_inf = Z1.is_zero(), q_inf = Z2.is_zero();
  const bool same = h_zero && r_zero;
  if (any_in_warp(same && !p_inf && !q_inf)) {
    E dX, dY;
    dbl_xy(dX, dY, X1, Y1);
    X3 = E::select(same, dX, X3);
    Y3 = E::select(same, dY, Y3);
    Z3 = E::select(same, E::dbl(Y1), Z3);
  }
  const bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  inf_selects(X3, Y3, Z3, to_inf, p_inf, q_inf, X1, Y1, Z1, X2, Y2, Z2);
  store3(args, i, live, X3, Y3, Z3);
}

// The madd-2007-bl add path of P (Jacobian) + (x2, y2) taken with Z2 = 1:
// 8 products and 3 squares. H = R = 0 when P == Q; H = 0, R != 0 when
// P == -Q. Shared by both mixed adds.
template <class E>
ZKT_HD void madd_add_path(E& X3, E& Y3, E& Z3, E& H, E& R, const E& X1,
                          const E& Y1, const E& Z1, const E& x2,
                          const E& y2) {
  E Z1Z1 = E::sqr(Z1);
  E U2 = E::mul(x2, Z1Z1);
  E S2 = E::mul(E::mul(y2, Z1), Z1Z1);
  H = E::sub(U2, X1);
  R = E::sub(S2, Y1);
  add_xy(X3, Y3, H, R, X1, Y1);
  Z3 = E::mul(Z1, H);
}

// Mixed add P (Jacobian) + Q (Z2 in {0, 1}: affine or infinity), madd-2007-bl
// with NO doubling path (pallas_curve.py:_make_madd_kernel(True)). Wrong when
// P == Q: callers use it only where the operands are distinct points.
template <class E>
ZKT_HD void jac_madd_nd_lane(const PointArgs& args, int64_t i,
                             bool live = true) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X1 = P::load(args.in + 0 * K, i), Y1 = P::load(args.in + 1 * K, i),
          Z1 = P::load(args.in + 2 * K, i);
  const E x2 = P::load(args.in + 3 * K, i), y2 = P::load(args.in + 4 * K, i),
          Z2 = P::load(args.in + 5 * K, i);
  E X3, Y3, Z3, H, R;
  madd_add_path(X3, Y3, Z3, H, R, X1, Y1, Z1, x2, y2);

  const bool p_inf = Z1.is_zero(), q_inf = Z2.is_zero();
  const bool to_inf = H.is_zero() && !p_inf && !q_inf;
  inf_selects(X3, Y3, Z3, to_inf, p_inf, q_inf, X1, Y1, Z1, x2, y2, Z2);
  store3(args, i, live, X3, Y3, Z3);
}

// Mixed add P (Jacobian) + Q (Z2 in {0, 1}: affine or infinity) WITH the
// doubling path (pallas_curve.py:_make_madd_kernel(False)): the madd-2007-bl
// add path, then where H = R = 0 (P == Q) the affine double (mdbl) of q
// with dZ = 2 y2, then the infinity and P + (-P) masks, in the Pallas
// kernel's order. Correct for every pair, duplicates included.
//
// Over every type a warp computes the doubling and its selects only if
// one of its lanes has H = R = 0 with neither operand infinite (the rule
// of jac_add_lane's vote); every lane's result is the same as when every
// lane computes it. The setup's fixed-base steps never take it: there P
// is (sum of d_w' 2^(8w'), w' < w) G and Q is d_w 2^(8w) G with both
// multipliers below r, equal only when both are 0 (infinity + infinity).
// Every kernel on this lane (g1.cu's g1_madd_kernel over FqCall, g2.cu's
// jac_madd_pair_kernel over Fq2Pair) launches whole warps and clamps its
// lane index past the ragged edge, so every thread reaches the vote.
template <class E>
ZKT_HD void jac_madd_lane(const PointArgs& args, int64_t i,
                          bool live = true) {
  using P = Planes<E>;
  constexpr int K = P::K;
  const E X1 = P::load(args.in + 0 * K, i), Y1 = P::load(args.in + 1 * K, i),
          Z1 = P::load(args.in + 2 * K, i);
  const E x2 = P::load(args.in + 3 * K, i), y2 = P::load(args.in + 4 * K, i),
          Z2 = P::load(args.in + 5 * K, i);
  E X3, Y3, Z3, H, R;
  madd_add_path(X3, Y3, Z3, H, R, X1, Y1, Z1, x2, y2);

  const bool h_zero = H.is_zero(), r_zero = R.is_zero();
  const bool p_inf = Z1.is_zero(), q_inf = Z2.is_zero();
  const bool same = h_zero && r_zero;
  if (any_in_warp(same && !p_inf && !q_inf)) {
    E dX, dY;
    dbl_xy(dX, dY, x2, y2);
    X3 = E::select(same, dX, X3);
    Y3 = E::select(same, dY, Y3);
    Z3 = E::select(same, E::dbl(y2), Z3);
  }
  const bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  inf_selects(X3, Y3, Z3, to_inf, p_inf, q_inf, X1, Y1, Z1, x2, y2, Z2);
  store3(args, i, live, X3, Y3, Z3);
}

}  // namespace zkt
