"""The least work a proof's MSMs and transforms need, and the H100's peaks:
the yardstick of the *_roofline and mfu.* metrics.

Inputs come from the configuration's sizes alone (its file's "msm_points",
"domain", "scalar_bits"), never from the launches, lanes or window size
the program uses, so that any implementation of the same proof reads the
same work. Each count is the least that any known route needs, so that no
implementation can read above 100%:

- a point addition costs the fewest field products any formula has:
  batch-affine, its inversion shared by Montgomery's trick (3 products a
  point) plus lambda, lambda^2 and lambda (x1 - x3): 6 Fq products in G1;
  over Fq2 (Karatsuba: 3 Fq products a product, 2 a square) 3 x 3 + 2 x 3
  + 2 = 17 Fq products in G2;
- an Fq product costs 2 x (27 + 64) + 8 = 190 32-bit multiply instructions:
  Karatsuba's 27 word products for the 8 x 8-word product (lo and hi
  half each), 64 for the Montgomery reduction, 8 for its quotient words;
- an MSM of n points with b-bit scalars takes, in Pippenger's method with
  signed windows of c bits, ceil(b / c) windows of n bucket additions and
  2^c additions to sum 2^(c-1) buckets (doublings left out); the best c
  for that n is taken, and in G1 the better of b = 254 over n points and
  GLV's half-length scalars, b = 127 over 2n points;
- each point and scalar is read once: 64 bytes a G1 point, 128 a G2 point,
  32 a scalar (affine coordinates and scalars of 256 bits);
- a transform of m = 2^k values takes k m / 2 butterflies of one Fr
  product each; a proof's quotient takes 7 (three inverse, three forward,
  one coset inverse).

Peaks (published): 3.35 TB/s of HBM3 (NVIDIA H100 SXM data sheet), and 32-bit
integer multiplies at 64 a clock an SM (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0) x 132 SMs x 1.98
GHz (the H100 SXM's boost clock) = 16.73 T/s. In practice the ceiling
sits well below 100%: a Montgomery product needs the high halves of its
word products (mad.hi), which an H100 issues at 0.346 of that rate (the
program's alu_mad_hi microbenchmark, PERF.md), and the bucket additions
are bound by memory latency of random gathers as much as by multiplies.
"""

from __future__ import annotations

import math
from typing import Dict

SMS = 132
CLOCK_HZ = 1.98e9
MULS_PER_CLOCK_SM = 64
PEAK_MULS = MULS_PER_CLOCK_SM * SMS * CLOCK_HZ      # 16.73e12 a second
PEAK_BYTES = 3.35e12                                # a second

FQ_PRODUCT_MULS = 2 * (27 + 64) + 8                 # 190
FR_PRODUCT_MULS = FQ_PRODUCT_MULS
ADD_PRODUCTS = {"g1": 6, "g2": 17}
POINT_BYTES = {"g1": 64, "g2": 128}
SCALAR_BYTES = 32
QUOTIENT_TRANSFORMS = 7


def pippenger_adds(n: int, bits: int) -> int:
    """Point additions of the best signed-window Pippenger over n points
    with `bits`-bit scalars."""
    if n <= 0:
        return 0
    return min(math.ceil(bits / c) * (n + (1 << c)) for c in range(1, 25))


def msm_adds(curve: str, n: int, bits: int) -> int:
    adds = pippenger_adds(n, bits)
    if curve == "g1":
        adds = min(adds, pippenger_adds(2 * n, (bits + 1) // 2))
    return adds


def msm_seconds(config: Dict, curve: str) -> float:
    """The least device seconds of the proof's MSMs on one curve: the
    larger of multiplies over the multiply peak and bytes over the memory
    peak, summed over that curve's tables."""
    bits = config["scalar_bits"]
    muls = nbytes = 0
    for n in config["msm_points"][curve].values():
        muls += (msm_adds(curve, n, bits) * ADD_PRODUCTS[curve]
                 * FQ_PRODUCT_MULS)
        nbytes += n * (POINT_BYTES[curve] + SCALAR_BYTES)
    return max(muls / PEAK_MULS, nbytes / PEAK_BYTES)


def quotient_seconds(config: Dict) -> float:
    m = config["domain"]
    k = m.bit_length() - 1
    muls = QUOTIENT_TRANSFORMS * k * (m // 2) * FR_PRODUCT_MULS
    nbytes = 4 * m * SCALAR_BYTES     # A, B, C evaluations in, h out
    return max(muls / PEAK_MULS, nbytes / PEAK_BYTES)


def proof_seconds(config: Dict) -> float:
    """The least device seconds of one proof: both curves' MSMs and the
    quotient's transforms."""
    return (msm_seconds(config, "g1") + msm_seconds(config, "g2")
            + quotient_seconds(config))
