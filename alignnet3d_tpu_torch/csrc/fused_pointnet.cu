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
// the semantics of fused_pointnet_xla with compute_dtype=bfloat16.
//
// What bounds it on Hopper: the arithmetic of the widest layer (128 x 1024
// for the embedding chain) on the FP32 FMA pipes; this first version does
// not use the tensor cores. Intermediate activations never reach device
// memory: a block keeps a tile of kTile points and its hidden activations
// in shared memory, and folds the last layer straight into a running
// per-column max. Each weight read from L2 feeds kPPT FMAs, and every
// shared-memory read is a warp-wide broadcast of four activations.
//
// Layout of a block: blockIdx.y is the cloud, blockIdx.x a run of
// kTilesPerBlock * kTile points. The cross-block max is an atomicMax on the
// int bits of the float into a zero-filled output: every value is a relu
// output (>= 0), where int order equals float order, so the result is exact
// and independent of block order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;              // points resident in shared memory
constexpr int kPPT = 16;               // points per work item
constexpr int kSplit = kTile / kPPT;   // work items per output column
constexpr int kTilesPerBlock = 4;
constexpr int kMaxLayers = 4;
constexpr int kMaxHidden = 256;        // widest input of any layer
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90

struct Chain {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int pad[kMaxLayers + 1];  // shared-memory row stride, a multiple of 4
  int maxpad;
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
fused_pointnet_kernel(const float* __restrict__ points, Chain chain,
                      int num_layers, int n, int round_bf16,
                      float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* const buf0 = smem;
  float* const buf1 = smem + kTile * chain.maxpad;
  float* colmax = smem + 2 * kTile * chain.maxpad;  // f_out * kSplit

  const int b = blockIdx.y;
  const int c_in = chain.dims[0];
  const int f_out = chain.dims[num_layers];
  const float* pts = points + (size_t)b * n * c_in;

  for (int i = threadIdx.x; i < f_out * kSplit; i += blockDim.x) {
    colmax[i] = 0.f;
  }

  for (int t = 0; t < kTilesPerBlock; ++t) {
    const int p0 = (blockIdx.x * kTilesPerBlock + t) * kTile;
    if (p0 >= n) break;  // uniform across the block
    const int valid = min(kTile, n - p0);

    // stage the tile; rows past n and columns past c_in are zero
    const int pin = chain.pad[0];
    for (int i = threadIdx.x; i < kTile * pin; i += blockDim.x) {
      const int p = i / pin, c = i % pin;
      float v = 0.f;
      if (p < valid && c < c_in) v = pts[(size_t)(p0 + p) * c_in + c];
      buf0[i] = round_bf16 ? to_bf16(v) : v;
    }
    __syncthreads();

    for (int l = 0; l < num_layers; ++l) {
      const float* hin = (l & 1) ? buf1 : buf0;
      float* hout = (l & 1) ? buf0 : buf1;
      const int ci = chain.dims[l], pi = chain.pad[l], co = chain.dims[l + 1];
      const float* __restrict__ W = chain.w[l];
      const float* __restrict__ bias = chain.b[l];
      const bool last = l == num_layers - 1;
      const int pout = last ? 0 : chain.pad[l + 1];

      for (int item = threadIdx.x; item < co * kSplit; item += blockDim.x) {
        // neighbouring threads take neighbouring columns: coalesced W reads
        const int j = item % co;
        const int part = item / co;
        const float* h = hin + part * kPPT * pi;
        float acc[kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) acc[q] = 0.f;
        for (int k = 0; k < ci; k += 4) {
          const float w0 = W[(size_t)k * co + j];
          const float w1 = k + 1 < ci ? W[(size_t)(k + 1) * co + j] : 0.f;
          const float w2 = k + 2 < ci ? W[(size_t)(k + 2) * co + j] : 0.f;
          const float w3 = k + 3 < ci ? W[(size_t)(k + 3) * co + j] : 0.f;
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float4 hv = *reinterpret_cast<const float4*>(h + q * pi + k);
            acc[q] = fmaf(hv.x, w0, acc[q]);
            acc[q] = fmaf(hv.y, w1, acc[q]);
            acc[q] = fmaf(hv.z, w2, acc[q]);
            acc[q] = fmaf(hv.w, w3, acc[q]);
          }
        }
        const float bj = bias[j];
        if (!last) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float v = fmaxf(acc[q] + bj, 0.f);
            hout[(part * kPPT + q) * pout + j] = round_bf16 ? to_bf16(v) : v;
          }
        } else {
          float m = colmax[item];
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            if (part * kPPT + q < valid) {
              const float v = fmaxf(acc[q] + bj, 0.f);
              m = fmaxf(m, round_bf16 ? to_bf16(v) : v);
            }
          }
          colmax[item] = m;
        }
      }
      // padding columns of the next layer's input must read as zero
      if (!last && pout > co) {
        const int extra = pout - co;
        for (int i = threadIdx.x; i < kTile * extra; i += blockDim.x) {
          hout[(i / extra) * pout + co + i % extra] = 0.f;
        }
      }
      __syncthreads();
    }
  }

  __syncthreads();
  for (int j = threadIdx.x; j < f_out; j += blockDim.x) {
    float m = colmax[j];
#pragma unroll
    for (int s = 1; s < kSplit; ++s) m = fmaxf(m, colmax[s * f_out + j]);
    atomicMax(reinterpret_cast<int*>(out + (size_t)b * f_out + j),
              __float_as_int(m));
  }
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
  chain.maxpad = 4;
  for (int l = 0; l <= num_layers; ++l) {
    if (dims[l] < 1) return (int)cudaErrorInvalidValue;
    chain.dims[l] = dims[l];
    chain.pad[l] = (dims[l] + 3) / 4 * 4;
    if (l < num_layers) {
      if (dims[l] > kMaxHidden) return (int)cudaErrorInvalidValue;
      chain.w[l] = static_cast<const float*>(weights[l]);
      chain.b[l] = static_cast<const float*>(biases[l]);
      chain.maxpad = chain.pad[l] > chain.maxpad ? chain.pad[l] : chain.maxpad;
    }
  }
  const int f_out = dims[num_layers];
  const size_t smem =
      (size_t)(2 * kTile * chain.maxpad + f_out * kSplit) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)batch * f_out * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_pointnet_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kTile * kTilesPerBlock;
  dim3 grid((n + per_block - 1) / per_block, batch);
  fused_pointnet_kernel<<<grid, kThreads, smem, s>>>(points, chain, num_layers,
                                                     n, round_bf16, out);
  return (int)cudaGetLastError();
}
