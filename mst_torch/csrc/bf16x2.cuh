// Packed bf16 pair arithmetic for the bf16 forms of K2 (grid_tail.cu) and
// K3 (grid_tail_bwd.cu), for Hopper (sm_90a).
//
// A pair is a uint32_t that holds two bf16 values: the low half is the
// first in memory. Each operation is one PTX instruction on both halves,
// and each half rounds once, to nearest even: the correctly rounded bf16
// result, which is also what one fp32 operation on the two bf16 values,
// rounded once to bf16, gives (a product of two bf16 values is exact in
// fp32, and fp32's 24 bits are at least 2 * 8 + 2, so a sum rounded twice
// rounds as if once). Subnormals are kept (no .ftz). The `.rn` on add and
// mul keeps ptxas from contracting a multiply and an add into one fused
// operation. There is deliberately no fused multiply-add here: it would
// round a product and a sum once instead of twice.

#pragma once

#include <stdint.h>

namespace bf16x2 {

constexpr uint32_t ONE = 0x3F803F80u;     // 1.0 in both halves
constexpr uint32_t SLOPE = 0x3C243C24u;   // bf16(0.01) = 0.010009765625

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xFFFF in each half where a >= b (so -0 >= 0), else 0
__device__ __forceinline__ uint32_t ge_mask(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.ge.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// two fp32 values rounded to bf16 (nearest even) in one instruction
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the halves as fp32 (exact)
__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// leaky_relu(0.01) of both halves: max(x, bf16(bf16(0.01) * x)), which is
// x >= 0 ? x : bf16(0.01) * x rounded, for every x that is not NaN
__device__ __forceinline__ uint32_t leaky(uint32_t x) {
  return bf16x2::max(x, bf16x2::mul(x, SLOPE));
}

// dLR(x) as a pair: 1.0 where x >= 0 (-0 included), bf16(0.01) elsewhere;
// mul(c, dleaky(x)) is dLR(x) * c rounded once, as the plain version's
// where(x >= 0, c, c * 0.01) is
__device__ __forceinline__ uint32_t dleaky(uint32_t x) {
  const uint32_t pos = bf16x2::ge_mask(x, 0u);
  return (ONE & pos) | (SLOPE & ~pos);
}

}  // namespace bf16x2
