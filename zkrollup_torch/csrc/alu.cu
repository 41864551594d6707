// The integer-unit microbenchmark: alu_throughput_kernel<OP>, six
// instantiations, and beside them mad_chain_kernel<HI>, two. It replaces tools/profile_vpu.py:make (the Pallas body
// run by pl.pallas_call at :56), which probes the TPU vector unit. Here it
// measures what the bound of the curve kernels only assumes: the rate of
// 32-bit multiplies (and of the other ops beside them) on the H100.
//
// Each op is what the TPU tool times, per lane of a (16, n) uint32 array:
//
//   acc = 0; repeat reps times: acc ^= op(a, b); a ^= acc;   out = acc
//
//   0 mul        a * b (low 32 bits)
//   1 add        a + b
//   2 shift_add  ((a >> 16) & 0xFFFF) + b
//   3 f32_mul12  u32(f32(a & 0xFFF) * f32(b & 0xFFF)): exact, the product
//                of two 12-bit values fits a float32 mantissa
//   4 mul16      (a & 0xFFFF) * (b & 0xFFFF)
//   5 umulhi     the high 32 bits of a * b (__umulhi): half of the
//                multiplies of the port's CIOS product are mad.hi
//
// One thread per column; its 16 rows are 16 independent chains, so each
// warp always has 16 instructions in flight that do not wait on each other.
// What bounds it: the op's issue rate, once reps is large. A lane reads 8 B
// and writes 4 B, so at reps = 16 (the TPU tool's value) device memory
// alone caps it at 3.35 TB/s / 12 B x 16 = 4.5 T lane-ops/s, below the
// 16.7 T/s multiply peak; the caller passes reps of 256 or more. Each rep
// also carries two XORs, which the measured rate includes. (ptxas -v for
// sm_90a, CUDA 12.8: 90 to 104 registers, no spill.)
//
// Beside the TPU tool's body, a multiply-only body (mad_chain_kernel<HI>,
// alu_mad_lo and alu_mad_hi): per row, reps dependent multiply-adds,
//
//   acc = a ^ b; repeat reps times: acc = mad(acc, a, b);   out = acc
//
// with mad.lo.u32 (the low 32 bits of acc * a + b) or mad.hi.u32 (the high
// 32 bits of acc * a, plus b), one IMAD or IMAD.HI a rep and nothing else
// but the loop's counter. Its time is the multiplier's rate on 16
// independent chains a thread, which the TPU body's XORs hide.
#include <cuda_runtime.h>

#include <cstdint>

#include "capi.cuh"

namespace zkt {

template <int OP>
__device__ __forceinline__ uint32_t alu_op(uint32_t a, uint32_t b) {
  if constexpr (OP == 0) {
    return a * b;
  } else if constexpr (OP == 1) {
    return a + b;
  } else if constexpr (OP == 2) {
    return ((a >> 16) & 0xFFFFu) + b;
  } else if constexpr (OP == 3) {
    return static_cast<uint32_t>(__uint2float_rn(a & 0xFFFu) *
                                 __uint2float_rn(b & 0xFFFu));
  } else if constexpr (OP == 4) {
    return (a & 0xFFFFu) * (b & 0xFFFFu);
  } else {
    return __umulhi(a, b);
  }
}

constexpr int ROWS = 16;

template <int OP>
__global__ void __launch_bounds__(256)
alu_throughput_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int64_t n, int reps) {
  int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[ROWS], y[ROWS], acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = a[r * n + col];
    y[r] = b[r * n + col];
    acc[r] = 0;
  }
#pragma unroll 4
  for (int k = 0; k < reps; ++k) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r] ^= alu_op<OP>(x[r], y[r]);
      x[r] ^= acc[r];
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * n + col] = acc[r];
}

template <bool HI>
__device__ __forceinline__ uint32_t mad_u32(uint32_t x, uint32_t y,
                                            uint32_t z) {
  uint32_t d;
  if constexpr (HI)
    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(z));
  else
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(z));
  return d;
}

template <bool HI>
__global__ void __launch_bounds__(256)
mad_chain_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 int64_t n, int reps) {
  int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[ROWS], y[ROWS], acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = a[r * n + col];
    y[r] = b[r * n + col];
    acc[r] = x[r] ^ y[r];
  }
#pragma unroll 4
  for (int k = 0; k < reps; ++k) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = mad_u32<HI>(acc[r], x[r], y[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * n + col] = acc[r];
}

template <class Kernel>
int launch_alu(Kernel kernel, const void* a, const void* b, void* out,
               int64_t n, int reps, void* stream) {
  if (n > 0)
    kernel<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n, reps);
  return int(cudaGetLastError());
}

}  // namespace zkt

extern "C" {

#define ZKT_ALU_API(NAME, KERNEL)                                          \
  int zkt_alu_##NAME(const void* a, const void* b, void* out, int64_t n,   \
                     int reps, void* stream) {                             \
    return zkt::launch_alu(KERNEL, a, b, out, n, reps, stream);            \
  }

ZKT_ALU_API(mul, zkt::alu_throughput_kernel<0>)
ZKT_ALU_API(add, zkt::alu_throughput_kernel<1>)
ZKT_ALU_API(shift_add, zkt::alu_throughput_kernel<2>)
ZKT_ALU_API(f32_mul12, zkt::alu_throughput_kernel<3>)
ZKT_ALU_API(mul16, zkt::alu_throughput_kernel<4>)
ZKT_ALU_API(umulhi, zkt::alu_throughput_kernel<5>)
ZKT_ALU_API(mad_lo, zkt::mad_chain_kernel<false>)
ZKT_ALU_API(mad_hi, zkt::mad_chain_kernel<true>)
#undef ZKT_ALU_API

}  // extern "C"
