// Fused BN-folded PointNet chain + max over points, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/pointnet_kernels.py
// (fused_pointnet_pallas / _kernel). Computes, for every cloud b,
//
//     out[b] = max_n relu(... relu(x[b, n] W1 + b1) ... W_L + b_L)
//
// with W_i of shape (C_i, C_{i+1}) row-major. When round_bf16 is set the
// input and every activation after its relu are rounded to bfloat16 (the
// weights arrive already rounded), and the products accumulate in f32:
// the semantics of fused_pointnet_xla with compute_dtype=bfloat16. Every
// output is fmaf over k in ascending order from 0, then + bias, then relu,
// the order of the plain version's float32 product at these widths.
//
// What bounds it on the H100: the FP32 FMA pipes, on the widest layer
// (128 x 1024 of the embedding chain's 139,456 MACs per point), and the
// shared memory that feeds them: an SM retires 4 warp FMAs a clock but
// reads only 128 bytes of shared memory a clock, so the operands of each
// FMA must come from registers most of the time. The float32 products stay
// off the tensor cores: TF32 would change the results. The design:
//
// - Point tile: a block holds P = 16 * MP points (128, or 64 for chains
//   whose activations do not fit) and every hidden activation of the chain
//   in shared memory, k-major ([k][p]), and folds the last layer straight
//   into a per-column max. No activation reaches device memory.
// - Register tiling: every layer is an outer product over k. Each of the
//   128 threads (16 point rows x 8 column groups) owns MP points x 16
//   columns of a kNC-column tile: one k-step reads MP + 16 values as
//   float4s from shared memory and issues 16 * MP FMAs (8 x 16: 24 values
//   for 128 FMAs; an 8 x 8 tile, 16 for 64, starves the FMA pipes). Two
//   blocks share an SM (about 247 registers a thread, 112 KB of shared
//   memory a block for the embedding chain).
// - Weight staging: kKC-row slices of each column tile of W stream from
//   L2 into a ring of kStages shared-memory buffers with cp.async, two
//   slices ahead of the one being multiplied, one barrier per slice.
//   Rows past C_i and columns past C_{i+1} are zero-filled, so the padded
//   k-steps add exact zeros.
// - The max over points: each thread reduces its points in registers,
//   shuffles combine the four point rows of a warp, a shared-memory
//   atomicMax combines the warps, and one global atomicMax per column and
//   block combines the blocks. These are the int bits of non-negative
//   floats (relu outputs) into a zero-filled output, where int order is
//   float order: the result is exact and independent of block order.
// - NaN propagates as in the plain version (torch.clamp_min, torch.amax)
//   and the JAX kernel (jnp.maximum, jnp.max): the relu and every max are
//   max.NaN.f32 (max_nan.cuh), whose NaN is the canonical 0x7fffffff, the
//   largest int, so a NaN also wins the atomicMax of the blocks.
// - bf16 rounding is a template parameter, so the f32 kernel carries none
//   of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "max_nan.cuh"

namespace {

constexpr int kThreads = 128;  // 16 point rows x kTX column groups
constexpr int kTX = 8;         // threads across a column tile
constexpr int kCols = 16;      // columns a thread owns: 4 float4 groups
constexpr int kNC = kTX * kCols;  // columns per tile
constexpr int kKC = 8;         // k rows per staged weight slice
constexpr int kStages = 3;     // weight slices in flight
constexpr int kMaxLayers = 4;
constexpr int kMaxHidden = 256;  // widest input of any layer
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Chain {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int kpad[kMaxLayers + 1];  // dims rounded up to kKC: rows in shared memory
  int rows[2];  // rows of the two activation buffers (even, odd layers)
  int vec4;     // every weight row is 16-byte aligned
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Slice (k0.., n0..) of W (K x N, row-major) into ws[kKC][kNC], zero
// outside K x N.
__device__ __forceinline__ void load_slice(float* ws, const float* W, int K,
                                           int N, int k0, int n0, int vec4) {
  if (vec4) {  // N % 4 == 0: a 4-column chunk is all inside or all outside
#pragma unroll
    for (int i = 0; i < kKC * kNC / 4 / kThreads; ++i) {
      const int x = threadIdx.x + i * kThreads;
      const int k = x / (kNC / 4), c = x % (kNC / 4) * 4;
      const bool in = k0 + k < K && n0 + c < N;
      cp_async16(ws + k * kNC + c, in ? W + (size_t)(k0 + k) * N + n0 + c : W,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kKC * kNC / kThreads; ++i) {
      const int x = threadIdx.x + i * kThreads;
      const int k = x / kNC, c = x % kNC;
      const bool in = k0 + k < K && n0 + c < N;
      cp_async4(ws + k * kNC + c, in ? W + (size_t)(k0 + k) * N + n0 + c : W,
                in ? 4 : 0);
    }
  }
}

// Stage s of a layer: rows (s % n_ks) * kKC.. of column tile s / n_ks,
// into ring slot s % kStages.
__device__ __forceinline__ void load_stage(float* ws, int s, int n_ks,
                                           const float* W, int K, int N,
                                           int vec4) {
  const int ct = s / n_ks, ks = s - ct * n_ks;
  load_slice(ws + s % kStages * kKC * kNC, W, K, N, ks * kKC, ct * kNC, vec4);
}

template <bool BF16>
__device__ __forceinline__ float act(float acc, float bias) {
  const float v = max_nan(__fadd_rn(acc, bias), 0.f);
  return BF16 ? to_bf16(v) : v;
}

// One layer over the block's point tile: hin [kpad][P] -> relu(hin^T W + b),
// into hout [out_rows][P] (a hidden layer; rows past N are written as 0)
// or, for the last layer, a max over the tile's valid points into colmax.
template <int MP, bool BF16>
__device__ __forceinline__ void layer(const float* hin, int kpad,
                                      const float* __restrict__ W,
                                      const float* __restrict__ bias, int K,
                                      int N, float* hout, int out_rows,
                                      int* colmax, int valid, float* ws,
                                      int vec4) {
  constexpr int P = 16 * MP;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int n_ks = kpad / kKC;
  const int stages = n_ks * ((N + kNC - 1) / kNC);

  load_stage(ws, 0, n_ks, W, K, N, vec4);
  cp_async_commit();
  if (stages > 1) load_stage(ws, 1, n_ks, W, K, N, vec4);
  cp_async_commit();

  float acc[MP][kCols];
  for (int s = 0; s < stages; ++s) {
    const int ct = s / n_ks, ks = s - ct * n_ks;
    cp_async_wait_prior();
    __syncthreads();  // slice s landed; every thread is done with slice s - 1
    if (s + 2 < stages) load_stage(ws, s + 2, n_ks, W, K, N, vec4);
    cp_async_commit();

    const float* w = ws + s % kStages * kKC * kNC + tx * 4;
    const float* h = hin + ks * kKC * P + ty * 4;
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      float a[MP], wv[kCols];
#pragma unroll
      for (int g = 0; g < MP / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(h + k * P + g * 64);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const float4 v =
            *reinterpret_cast<const float4*>(w + k * kNC + c * 4 * kTX);
        wv[4 * c] = v.x;
        wv[4 * c + 1] = v.y;
        wv[4 * c + 2] = v.z;
        wv[4 * c + 3] = v.w;
      }
      if (k == 0 && ks == 0) {  // fmaf(a, w, 0) up to the sign of a zero
#pragma unroll
        for (int i = 0; i < MP; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = __fmul_rn(a[i], wv[j]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < MP; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
          }
        }
      }
    }

    if (ks == n_ks - 1) {  // the column tile is complete
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = ct * kNC + c * 4 * kTX + tx * 4 + j;
          const float bj = n < N ? bias[n] : 0.f;
          if (hout) {
            if (n < out_rows) {  // zero weights and bias past N: exact 0
#pragma unroll
              for (int g = 0; g < MP / 4; ++g) {
                float4 o;
                o.x = act<BF16>(acc[4 * g][4 * c + j], bj);
                o.y = act<BF16>(acc[4 * g + 1][4 * c + j], bj);
                o.z = act<BF16>(acc[4 * g + 2][4 * c + j], bj);
                o.w = act<BF16>(acc[4 * g + 3][4 * c + j], bj);
                *reinterpret_cast<float4*>(hout + n * P + g * 64 + ty * 4) = o;
              }
            }
          } else {
            float m = 0.f;
#pragma unroll
            for (int i = 0; i < MP; ++i) {
              if (i / 4 * 64 + ty * 4 + i % 4 < valid) {
                m = max_nan(m, act<BF16>(acc[i][4 * c + j], bj));
              }
            }
            // lanes l ^ 8, l ^ 16, l ^ 24 hold the same columns of the
            // warp's other three point rows
            m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, 8));
            m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, 16));
            if ((threadIdx.x & 24) == 0 && n < N && !(m <= 0.f)) {  // NaN too
              atomicMax(colmax + n, __float_as_int(m));
            }
          }
        }
      }
    }
  }
  __syncthreads();  // hout or colmax complete; the slice buffers are free
}

// grid (point tiles, batch)
template <int MP, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
fused_pointnet_kernel(const float* __restrict__ points,
                      const __grid_constant__ Chain chain, int num_layers,
                      int n, float* __restrict__ out) {
  constexpr int P = 16 * MP;
  extern __shared__ float4 smem_f4[];
  float* const buf0 = reinterpret_cast<float*>(smem_f4);  // even layers' input
  float* const buf1 = buf0 + chain.rows[0] * P;            // odd layers' input
  float* const ws = buf1 + chain.rows[1] * P;
  int* const colmax = reinterpret_cast<int*>(ws + kStages * kKC * kNC);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P;
  const int valid = min(P, n - p0);
  const int c_in = chain.dims[0];
  const int f_out = chain.dims[num_layers];
  const float* pts = points + ((size_t)b * n + p0) * c_in;

  for (int i = threadIdx.x; i < f_out; i += kThreads) colmax[i] = 0;
  // the input, k-major; rows past c_in and points past n are zero
  for (int i = threadIdx.x; i < chain.kpad[0] * P; i += kThreads) {
    const int c = i / P, p = i % P;
    const float v = c < c_in && p < valid ? pts[(size_t)p * c_in + c] : 0.f;
    buf0[i] = BF16 ? to_bf16(v) : v;
  }
  // (published by the first layer's first barrier)

  for (int l = 0; l < num_layers; ++l) {
    const bool last = l == num_layers - 1;
    float* const hin = l & 1 ? buf1 : buf0;
    float* const hout = last ? nullptr : l & 1 ? buf0 : buf1;
    layer<MP, BF16>(hin, chain.kpad[l], chain.w[l], chain.b[l], chain.dims[l],
                    chain.dims[l + 1], hout, chain.kpad[l + 1], colmax, valid,
                    ws, chain.vec4);
  }

  for (int j = threadIdx.x; j < f_out; j += kThreads) {
    const int m = colmax[j];
    if (m) atomicMax(reinterpret_cast<int*>(out + (size_t)b * f_out + j), m);
  }
}

template <int MP, bool BF16>
int launch(const float* points, int batch, int n, int num_layers,
           const Chain& chain, size_t smem, float* out, cudaStream_t s) {
  auto kernel = fused_pointnet_kernel<MP, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as much of the SM's L1 as shared memory as it allows: two blocks an SM
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  constexpr int P = 16 * MP;
  const dim3 grid((n + P - 1) / P, batch);
  kernel<<<grid, kThreads, smem, s>>>(points, chain, num_layers, n, out);
  return (int)cudaGetLastError();
}

template <int MP>
int launch_tile(const float* points, int batch, int n, int num_layers,
                const Chain& chain, int round_bf16, size_t smem, float* out,
                cudaStream_t s) {
  return round_bf16
             ? launch<MP, true>(points, batch, n, num_layers, chain, smem, out, s)
             : launch<MP, false>(points, batch, n, num_layers, chain, smem, out,
                                 s);
}

}  // namespace

// points: (batch, n, dims[0]) f32 on the device; weights[l]: device pointer
// to a (dims[l], dims[l+1]) f32 matrix; biases[l]: (dims[l+1],) f32;
// out: (batch, dims[num_layers]) f32. dims, weights and biases are host
// arrays. Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_pointnet_launch(const float* points, int batch, int n,
                                     int num_layers, const int* dims,
                                     const void* const* weights,
                                     const void* const* biases, int round_bf16,
                                     float* out, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || batch < 1 || n < 1 ||
      batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Chain chain;
  chain.rows[0] = chain.rows[1] = 0;
  chain.vec4 = 1;
  for (int l = 0; l <= num_layers; ++l) {
    if (dims[l] < 1) return (int)cudaErrorInvalidValue;
    chain.dims[l] = dims[l];
    chain.kpad[l] = (dims[l] + kKC - 1) / kKC * kKC;
    if (l < num_layers) {
      if (dims[l] > kMaxHidden) return (int)cudaErrorInvalidValue;
      chain.w[l] = static_cast<const float*>(weights[l]);
      chain.b[l] = static_cast<const float*>(biases[l]);
      chain.rows[l & 1] = chain.kpad[l] > chain.rows[l & 1] ? chain.kpad[l]
                                                          : chain.rows[l & 1];
      if (dims[l + 1] % 4 != 0 ||
          reinterpret_cast<std::uintptr_t>(weights[l]) % 16 != 0) {
        chain.vec4 = 0;
      }
    }
  }
  const int f_out = dims[num_layers];
  auto smem_for = [&](int p) {
    return (size_t)((chain.rows[0] + chain.rows[1]) * p +
                    kStages * kKC * kNC + f_out) * sizeof(float);
  };

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)batch * f_out * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (smem_for(128) <= (size_t)kMaxSmem) {
    return launch_tile<8>(points, batch, n, num_layers, chain, round_bf16,
                          smem_for(128), out, s);
  }
  if (smem_for(64) <= (size_t)kMaxSmem) {
    return launch_tile<4>(points, batch, n, num_layers, chain, round_bf16,
                          smem_for(64), out, s);
  }
  return (int)cudaErrorInvalidValue;
}
