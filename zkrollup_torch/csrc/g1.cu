// The G1 point kernels (over Fq): the six templates of points.cuh, one
// instantiation each (g1_add, g1_add_nd, g1_add_z01, g1_madd_nd, g1_madd,
// g1_double). Built by its own nvcc, beside g2.cu, fields.cu and alu.cu.
#include "points.cuh"

ZKT_CURVE_API(g1, zkt::Fq)
