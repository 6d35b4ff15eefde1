// A max that propagates NaN, for the relus and maxima of the kernels.
//
// fmaxf returns the other operand when one is NaN, so relu(NaN) would be 0
// and a NaN would drop out of a max. torch.relu, torch.amax/argmax and
// jnp.maximum/jnp.max propagate it. One instruction does so on sm_80+:
// max.NaN.f32 returns the canonical NaN (0x7fffffff) when either operand
// is NaN, and otherwise the same value as fmaxf.

#pragma once

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
