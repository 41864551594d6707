// The G2 point kernels (over Fq2): the six templates of points.cuh, one
// instantiation each (g2_add, g2_add_nd, g2_add_z01, g2_madd_nd, g2_madd,
// g2_double). Built by its own nvcc, beside g1.cu, fields.cu and alu.cu.
#include "points.cuh"

ZKT_CURVE_API(g2, zkt::Fq2)
