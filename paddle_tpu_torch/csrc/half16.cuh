// The two 16-bit operand types of the tensor-core kernels, bf16 and f16,
// behind one set of helpers, so that each kernel body is written once as
// a template on its operand type T (__nv_bfloat16 or __half) and both
// instantiations keep the same f32 accumulation and the same rounding
// points. Included by flash_attn.cu, fused_loss.cu and fused_conv.cu
// (every build hashes this file with its source: ops/_build.py).
//
// The dtype codes the C entry points take: 0 f32, 1 bf16, 2 f16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace half16 {

template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;

// two f32 values rounded to nearest into one 32-bit pair of T (lo in
// the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kF16<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// the f32 value (exact) of the 16-bit code `bits` of T
template <typename T>
__device__ __forceinline__ float bits_f32(uint32_t bits) {
  if constexpr (kF16<T>)
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  else
    return __uint_as_float(bits << 16);
}

// c += a b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), T in,
// f32 accumulators (the same fragment layout in both types)
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
#define HALF16_MMA(TY)                                                     \
  asm("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "          \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"  \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (kF16<T>)
    HALF16_MMA("f16");
  else
    HALF16_MMA("bf16");
#undef HALF16_MMA
}

}  // namespace half16
