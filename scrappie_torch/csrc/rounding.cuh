// Operand rounding of the precision policy (scrappie_torch/nn/config.py),
// shared by the kernels with products: the projection (project.cu), the
// head (head.cu), the GRU and LSTM recurrences and their backward walks
// (gru.cu, lstm.cu).
//
// kRound 0 leaves an fp32 operand as it is ('highest'); 1 rounds it to
// TF32 ('default' on the card): the low 13 mantissa bits rounded half
// away from zero, then zeroed (cvt.rna.tf32.f32); 2 rounds it to bfloat16
// with round to nearest even ('bf16'). A kernel rounds a weight once where
// it loads it (round_weight) and an activation where it is formed
// (round_operand), then multiplies and sums in fp32 FMAs as in 'highest';
// the products of rounded operands are exact in fp32, so a kernel and its
// twin (nn/config.round_operand) differ only in the order of the sums.
// round_weight takes TF32's rounding on the integer bits, which the
// compiler schedules with the loads (as an inline cvt.rna.tf32.f32 the
// LSTM recurrence's 96 weights a thread spilled; round_weight_bits does
// the same for bfloat16 there); both give every finite value the same
// bits, and pass Inf and NaN on as Inf and NaN. The C entry
// points take the mode as an int and dispatch once to a template
// instance, so 'highest' runs the same code as before the policy existed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

template <int kRound>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (kRound == 1) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r & 0xffffe000u);
  } else if constexpr (kRound == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <int kRound>
__device__ __forceinline__ float round_weight(float x) {
  if constexpr (kRound == 1) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x7f800000u) == 0x7f800000u
               ? x
               : __uint_as_float((u + 0x1000u) & 0xffffe000u);
  } else {
    return round_operand<kRound>(x);
  }
}

// round_weight with bfloat16's rounding on the integer bits too (round to
// nearest even), for the LSTM recurrence's 96 weights a thread, whose
// training mode spilled with cvt.rn.bf16.f32 at their loads.
template <int kRound>
__device__ __forceinline__ float round_weight_bits(float x) {
  if constexpr (kRound == 2) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x7f800000u) == 0x7f800000u
               ? x
               : __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  } else {
    return round_weight<kRound>(x);
  }
}

// The backward of a product whose forward rounded by kRound
// (nn/config.grad_rounding): TF32 rounds the cotangent operand as well
// (round_cotangent), bfloat16 the product's result (round_result, the VJP
// of the forward's cast); each leaves the other as it is.
template <int kRound>
__device__ __forceinline__ float round_cotangent(float x) {
  return kRound == 1 ? round_operand<1>(x) : x;
}

template <int kRound>
__device__ __forceinline__ float round_result(float x) {
  return kRound == 2 ? round_operand<2>(x) : x;
}

template <int kRound>
__device__ __forceinline__ float4 round_operand4(float4 v) {
  return make_float4(round_operand<kRound>(v.x), round_operand<kRound>(v.y),
                     round_operand<kRound>(v.z), round_operand<kRound>(v.w));
}

// f(std::integral_constant<int, R>{}) for R = rounding (0, 1 or 2), so the
// entry point picks its template instance once; cudaErrorInvalidValue for
// any other mode.
template <typename F>
int with_rounding(int rounding, F f) {
  switch (rounding) {
    case 0:
      return f(std::integral_constant<int, 0>{});
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
