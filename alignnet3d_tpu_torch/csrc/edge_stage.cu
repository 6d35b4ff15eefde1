// Fused DGCNN edge-conv stage over a kNN graph, BN folded, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/edge_conv_kernels.py
// (fused_edge_stage / _edge_kernel). With U = x (P - Q) + b1 and V = x Q
// computed by the caller, it writes for every point i of cloud b
//
//     out[b, i] = max_t relu(relu(U[b, i] + V[b, idx[b, i, t]]) W2 + b2),
//
// W2 of shape (C1, C2) row-major, all in float32 with FP32 FMAs (no TF32:
// the TPU kernel accumulates f32 operands in f32). The TPU kernel gathers
// the V rows with a one-hot matmul on the MXU; here the gather is an
// indexed load, and neither the (B, N, k, C1) edge tensor nor the
// (B, N, k, C2) activations reach device memory.
//
// What bounds it on Hopper: the k x C1 x C2 product per point on the FP32
// pipes. At the serving shape (B=256 clouds, N=512, k=20, C1=64, C2=128)
// that is 2.62 M edges x 16,384 FLOP = 42.9 GFLOP, ~0.64 ms at 67 TFLOP/s;
// the bytes (U, V, idx, out, ~155 MB) take ~46 us. The design keeps W2 in
// shared memory for a block's strip of kPoints points, stages the
// relu(U_i + V_j) rows of kGroup points (k edges each) next to it, and
// gives each of the kGroup points its own kColThreads threads, each with
// kCols output channels: per step of 4 input channels a thread reads
// 4 x kCols W2 words and kEdges broadcast float4 edge rows for
// 4 x kEdges x kCols FMAs, enough to keep the shared-memory port below the
// FMA rate. The max over the k edges runs in registers; relu outputs are
// >= 0, so the max starts from 0. Tensor cores (3xTF32 or bf16 wgmma on the
// strip's (kGroup k) x C1 x C2 product) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kColThreads = 64;  // threads per point
constexpr int kCols = 2;         // channels per thread: j, j + kColThreads
constexpr int kEdges = 10;       // edges accumulated together
constexpr int kPoints = 32;      // points per block (one W2 staging)
constexpr int kGroup = 4;        // points whose edges are staged at once
constexpr int kThreads = kColThreads * kGroup;  // one point per 64 threads
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
edge_stage_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const long long* __restrict__ idx,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  int n, int k, int c1, int c2, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int c1p = (c1 + 3) / 4 * 4;
  float* const w2s = smem;              // (c1p, c2); rows past c1 are zero
  float* const h1s = smem + c1p * c2;   // (kGroup * k + kEdges, c1p)
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p_base = blockIdx.x * kPoints;
  const size_t cloud = (size_t)b * n;

  for (int e = tid; e < c1p * c2; e += kThreads) {
    w2s[e] = e < c1 * c2 ? w2[e] : 0.f;
  }
  // the rows past a group's last edge are read but never enter the max
  const int tile_rows = kGroup * k + kEdges;
  const int p = tid / kColThreads;  // this thread's point of each group
  const int lane = tid % kColThreads;

  for (int g = 0; g < kPoints; g += kGroup) {
    const int p0 = p_base + g;
    if (p0 >= n) break;  // uniform across the block
    const int np = min(kGroup, n - p0);
    __syncthreads();  // W2 is staged; the previous tile is no longer read
    for (int e = tid; e < tile_rows * c1p; e += kThreads) {
      const int r = e / c1p, c = e % c1p;
      float val = 0.f;
      if (r < np * k && c < c1) {
        const size_t i = cloud + p0 + r / k;
        const long long j = idx[i * k + r % k];
        val = fmaxf(u[i * c1 + c] + v[(cloud + j) * c1 + c], 0.f);
      }
      h1s[e] = val;
    }
    __syncthreads();

    for (int jb = 0; p < np && jb < c2; jb += kColThreads * kCols) {
      int col[kCols];
      float bias[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        col[q] = jb + lane + q * kColThreads;
        bias[q] = col[q] < c2 ? b2[col[q]] : 0.f;
        col[q] = min(col[q], c2 - 1);  // idle lanes read a valid column
      }
      float m[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) m[q] = 0.f;
      for (int t0 = 0; t0 < k; t0 += kEdges) {
        const float* hrow = h1s + (p * k + t0) * c1p;
        float acc[kEdges][kCols];
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[e][q] = 0.f;
        }
        for (int c = 0; c < c1p; c += 4) {
          float w[4][kCols];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) w[r][q] = w2s[(c + r) * c2 + col[q]];
          }
#pragma unroll
          for (int e = 0; e < kEdges; ++e) {
            const float4 h =
                *reinterpret_cast<const float4*>(hrow + e * c1p + c);
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              acc[e][q] = fmaf(h.x, w[0][q], acc[e][q]);
              acc[e][q] = fmaf(h.y, w[1][q], acc[e][q]);
              acc[e][q] = fmaf(h.z, w[2][q], acc[e][q]);
              acc[e][q] = fmaf(h.w, w[3][q], acc[e][q]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (t0 + e < k) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              m[q] = fmaxf(m[q], fmaxf(acc[e][q] + bias[q], 0.f));
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (jb + lane + q * kColThreads < c2) {
          out[(cloud + p0 + p) * c2 + col[q]] = m[q];
        }
      }
    }
  }
}

}  // namespace

// u, v: (batch, n, c1) f32; idx: (batch, n, k) int64 with entries in
// [0, n); w2: (c1, c2) f32; b2: (c2,) f32; out: (batch, n, c2) f32; all on
// the device. Returns the CUDA error code of the launch (0 on success).
extern "C" int edge_stage_launch(const float* u, const float* v,
                                 const long long* idx, const float* w2,
                                 const float* b2, int batch, int n, int k,
                                 int c1, int c2, float* out, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || k < 1 || k > n || c1 < 1 ||
      c2 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t c1p = (size_t)(c1 + 3) / 4 * 4;
  const size_t smem =
      (c1p * c2 + (size_t)(kGroup * k + kEdges) * c1p) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edge_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + kPoints - 1) / kPoints, batch);
  edge_stage_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      u, v, idx, w2, b2, n, k, c1, c2, out);
  return (int)cudaGetLastError();
}
