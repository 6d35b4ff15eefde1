// Brute-force nearest-neighbour argmin over batched point clouds, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/nn_kernels.py
// (nn_argmin_pallas / _nn_kernel), and takes the batch axis natively where
// the JAX callers vmap it. For every source point a of pair b it returns
// the index and squared distance of the nearest valid destination point:
//
//     d2(a, q) = max((|a|^2 - 2 a.q) + |q|^2, 0),   +inf where q is masked,
//
// the first (lowest) index winning ties. The cross term is summed as
// ((a0 q0' + a1 q1') + a2 q2') with q' = -2 q, which is -2 a.q exactly.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// contraction into FMAs), in the order the plain PyTorch version
// nn_argmin_plain evaluates them, so the two agree bit for bit. The
// expansion stays in full f32 on the CUDA cores: a reduced-precision cross
// term (tensor cores, TF32) breaks the argmin, as it did for the TPU
// kernel's first version.
//
// What bounds it on Hopper: FP32 arithmetic, about ten operations per
// (source, destination) pair with nothing to reuse across pairs. The design
// keeps the memory side out of the way: one thread per source point holds
// its point in registers, and the block stages kTile destination points as
// float4 (-2x, -2y, -2z, |q|^2 or +inf) in shared memory, where every read
// is a broadcast. The columns are swept in ascending order with strict-less
// updates, which gives the lowest index on ties.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
nn_argmin_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const unsigned char* __restrict__ mask, int n1, int n2,
                 long long* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n1;
  const float* a = src + ((size_t)b * n1 + (active ? i : 0)) * 3;
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const float sa = sq_norm(a0, a1, a2);
  const float* d = dst + (size_t)b * n2 * 3;
  const unsigned char* m = mask + (size_t)b * n2;

  float best = CUDART_INF_F;
  long long best_idx = 0;
  for (int j0 = 0; j0 < n2; j0 += kTile) {
    const int cnt = min(kTile, n2 - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float* q = d + (size_t)(j0 + t) * 3;
      const float x = q[0], y = q[1], z = q[2];
      tile[t] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                            m[j0 + t] ? sq_norm(x, y, z) : CUDART_INF_F);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float4 q = tile[t];
      const float cross2 = __fadd_rn(
          __fadd_rn(__fmul_rn(a0, q.x), __fmul_rn(a1, q.y)),
          __fmul_rn(a2, q.z));
      const float d2 = fmaxf(__fadd_rn(__fadd_rn(sa, cross2), q.w), 0.f);
      if (d2 < best) {
        best = d2;
        best_idx = j0 + t;
      }
    }
  }
  if (active) {
    out_idx[(size_t)b * n1 + i] = best_idx;
    out_d2[(size_t)b * n1 + i] = best;
  }
}

}  // namespace

// src: (batch, n1, 3) f32, dst: (batch, n2, 3) f32, mask: (batch, n2) bytes
// (non-zero = valid), all on the device; out_idx: (batch, n1) int64,
// out_d2: (batch, n1) f32. Returns the CUDA error code of the launch.
extern "C" int nn_argmin_launch(const float* src, const float* dst,
                                const unsigned char* mask, int batch, int n1,
                                int n2, long long* out_idx, float* out_d2,
                                void* stream) {
  if (batch < 1 || n1 < 1 || n2 < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((n1 + kThreads - 1) / kThreads, batch);
  nn_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, mask, n1, n2, out_idx, out_d2);
  return (int)cudaGetLastError();
}
