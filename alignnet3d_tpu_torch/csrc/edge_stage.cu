// Fused DGCNN edge-conv stage over a kNN graph, BN folded, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/edge_conv_kernels.py
// (fused_edge_stage / _edge_kernel). With U = x (P - Q) + b1 and V = x Q
// computed by the caller, it writes for every point i of cloud b
//
//     out[b, i] = max_t relu(relu(U[b, i] + V[b, idx[b, i, t]]) W2 + b2),
//
// W2 of shape (C1, C2) row-major, in float32 accuracy: the TPU kernel casts
// its operands to f32 and accumulates in f32. The TPU kernel gathers the V
// rows with a one-hot matmul on the MXU; here the gather is an indexed
// load, and neither the (B, N, k, C1) edge tensor nor the (B, N, k, C2)
// activations reach device memory. (The one-hot product also spreads one
// non-finite V row to the whole cloud, 0 x inf = NaN; the gather does not,
// as the function the TPU kernel's docstring states.)
//
// What bounds it on Hopper: the k x C1 x C2 product per point. At the
// serving shape (B=256 clouds, N=512, k=20, C1=64, C2=128) that is 2.62 M
// edges x 16,384 FLOP = 42.9 GFLOP: ~0.64 ms on the FP32 pipes at 67
// TFLOP/s. This kernel runs it on the tensor cores in 3xTF32: every
// operand is split as a = a_big + a_small with a_big in TF32 (W2 rounded
// once, the activations cut, see split()), and a_small W_big + a_big
// W_small + a_big W_big is accumulated in f32 by mma.sync.m16n8k8 (the
// a_small W_small term, < 2^-20 relative, is dropped); 3 x 42.9 GFLOP at
// 495 TFLOP/s is ~0.26 ms. The bytes (U, V, idx, out, ~155 MB) take ~46 us.
//
// Design. The wrapper pads U and V to kC1 = 64 channels (zero weight
// columns). A block takes a strip of kStrip points of one cloud and stages
// in shared memory W2 split into (big, small) B fragments, b2, and, when it
// fits, the whole cloud's V rows (else they are read from L2). A warp takes
// 16 points x 64 output channels (8 n-tiles), holds the 16 U rows in
// registers in the A-fragment layout, and walks the k slots kSlots at a
// time: each slot's A tile, relu(U_i + V_idx[i,t]), is built in registers
// from V rows gathered with float4 loads (the K dimension is permuted so
// that a thread's four channels of a float4 are its fragment columns; W2's B
// fragments use the same permutation), split, and multiplied. A thread's
// accumulator covers the same (point, channel) positions in every slot, so
// relu(acc + b2) and the max over k are elementwise in registers. A warp's
// unit is 16 points x kSlots = 2 slots x 64 channels: per B fragment (one
// 128-bit shared load) 6 mma, and per V row gathered 8 n-tiles; its
// accumulators, maxima, U rows and split activations take the 255 registers
// a thread may have (ptxas: no spill with V in shared memory). One
// 256-thread block an SM (229,888 B of shared memory at N=512). Every relu
// and max is max.NaN.f32 (max_nan.cuh), as torch.relu and amax propagate
// NaN; split() keeps an infinite activation from turning into NaN.

#include <cuda_runtime.h>

#include <stdint.h>

#include "max_nan.cuh"

namespace {

constexpr int kC1 = 64;               // U/V row width (padded by the wrapper)
constexpr int kVStride = kC1 + 16;    // V row stride in shared memory, floats
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 256;           // points of a block
constexpr int kTiles = 8;             // n-tiles (8 channels) of a warp's unit
constexpr int kSlots = 2;             // k slots multiplied per B fragment
constexpr int kKSteps = kC1 / 8;      // k8 steps of the product
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, row) * B (8 x 8, col), TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Loads the compiler may not hoist: the W2 fragments and b2 do not change
// with the slot, and hoisted out of the slot loop they would take 256 + 16
// registers a thread; the V rows, hoisted across k-steps, 32 more.
__device__ __forceinline__ float4 lds_f4(const float4* p) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return r;
}

__device__ __forceinline__ float4 ldg_f4(const float* p) {
  float4 r;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 r;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(r.x), "=f"(r.y)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return r;
}

// One activation h = relu(...) >= 0 or NaN, split for 3xTF32: big = h
// with its low 13 bits cut (NaN and +inf stay so) feeds the W_big
// product. The other two parts come from c = min(h, FLT_MAX), finite: fin
// = c cut feeds the W_small product, small = c - fin (exact, < 2^-10 c;
// the tensor core cuts it to TF32 too, an error < 2^-20 of h) the W_big
// one. For h = +inf, inf x W_small = inf x 0 would be NaN where f32 gives
// inf; the finite parts add only finite terms to a sum big x W_big makes
// infinite (or NaN, as f32 does, for W = 0). For finite h, c = h.
struct Split {
  uint32_t big, fin, small;
};

__device__ __forceinline__ Split split(float h) {
  constexpr uint32_t kTf32 = 0xffffe000u;
  const float c = fminf(h, 3.402823466e38f);
  Split s;
  s.big = __float_as_uint(h) & kTf32;
  s.fin = __float_as_uint(c) & kTf32;
  s.small = __float_as_uint(c - __uint_as_float(s.fin));
  return s;
}

// The permuted K: in k-step kk, fragment column t4 of A (row t4 of B) is
// channel k_channel(kk, t4) of U/V (row of W2), column t4 + 4 the next one.
// So a thread's float4 of channels 16q + 4 t4 + {0..3} feeds k-steps 2q
// and 2q + 1. A lane's B fragment is stored as (big0, big1, small0,
// small1).
__device__ __forceinline__ int k_channel(int kk, int t4) {
  return 16 * (kk >> 1) + 4 * t4 + 2 * (kk & 1);
}

template <bool kSmemV>
__global__ void __launch_bounds__(kThreads, 1)
edge_stage_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const long long* __restrict__ idx,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  int n, int k, int c1, int c2, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  // n-tiles of 8 channels, padded with zero columns to whole warp units
  const int ntiles = (c2 + 8 * kTiles - 1) / (8 * kTiles) * kTiles;
  float4* const ws = smem;  // (kKSteps, ntiles, 32) B fragments
  float* const bs = reinterpret_cast<float*>(ws + kKSteps * ntiles * 32);
  float* const vs = bs + ntiles * 8;  // (n, kVStride) when kSmemV
  const int tid = threadIdx.x;
  const size_t cloud = (size_t)blockIdx.y * n;

  for (int e = tid; e < kKSteps * ntiles * 32; e += kThreads) {
    const int lane = e & 31, kk = (e >> 5) / ntiles, nt = (e >> 5) % ntiles;
    const int ch = k_channel(kk, lane & 3), col = nt * 8 + (lane >> 2);
    float w0 = 0.f, w1 = 0.f;
    if (col < c2) {
      if (ch < c1) w0 = w2[(size_t)ch * c2 + col];
      if (ch + 1 < c1) w1 = w2[(size_t)(ch + 1) * c2 + col];
    }
    const uint32_t g0 = tf32(w0), g1 = tf32(w1);
    ws[e] = make_float4(__uint_as_float(g0), __uint_as_float(g1),
                        __uint_as_float(tf32(w0 - __uint_as_float(g0))),
                        __uint_as_float(tf32(w1 - __uint_as_float(g1))));
  }
  for (int e = tid; e < ntiles * 8; e += kThreads) {
    bs[e] = e < c2 ? b2[e] : 0.f;
  }
  if (kSmemV) {
    const float4* vg = reinterpret_cast<const float4*>(v + cloud * kC1);
    for (int e = tid; e < n * (kC1 / 4); e += kThreads) {
      const int r = e / (kC1 / 4), q = e % (kC1 / 4);
      *reinterpret_cast<float4*>(vs + (size_t)r * kVStride + 4 * q) = vg[e];
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int p_base = blockIdx.x * kStrip;
  const int n_groups = (min(kStrip, n - p_base) + 15) / 16;
  const int n_chunks = ntiles / kTiles;
  const float* const vbase = kSmemV ? vs : v + cloud * kC1;
  const int vstride = kSmemV ? kVStride : kC1;

  for (int unit = warp; unit < n_groups * n_chunks; unit += kWarps) {
    const int nt0 = (unit % n_chunks) * kTiles;
    const int p0 = p_base + (unit / n_chunks) * 16 + g;
    // fragment rows g and g + 8; rows past the cloud repeat its last point
    const int pt[2] = {min(p0, n - 1), min(p0 + 8, n - 1)};
    float4 uu[2][kKSteps / 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4* ur =
          reinterpret_cast<const float4*>(u + (cloud + pt[r]) * kC1);
#pragma unroll
      for (int q = 0; q < kKSteps / 2; ++q) uu[r][q] = ur[4 * q + t4];
    }
    const long long* irow[2] = {idx + (cloud + pt[0]) * k,
                                idx + (cloud + pt[1]) * k};
    float m[kTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[nt][e] = 0.f;
    }
    // slots t .. t + kSlots - 1 (past k, the last slot again: the max is
    // unchanged); the next group's indices are loaded a group ahead
    int j[kSlots][2], jn[kSlots][2];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int r = 0; r < 2; ++r) jn[s][r] = (int)irow[r][min(s, k - 1)];
    }
    for (int t = 0; t < k; t += kSlots) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int r = 0; r < 2; ++r) j[s][r] = jn[s][r];
      }
      if (t + kSlots < k) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            jn[s][r] = (int)irow[r][min(t + kSlots + s, k - 1)];
          }
        }
      }
      float acc[kSlots][kTiles][4];
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const float2 bias = lds_f2(bs + (nt0 + nt) * 8 + 2 * t4);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          acc[s][nt][0] = acc[s][nt][2] = bias.x;
          acc[s][nt][1] = acc[s][nt][3] = bias.y;
        }
      }
#pragma unroll
      for (int q = 0; q < kKSteps / 2; ++q) {
        // channels 16q + 4 t4 + {0..3} of both rows, every slot: k-steps
        // 2q (components x, y) and 2q + 1 (components z, w)
        float4 hv[kSlots][2];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* vp =
                vbase + (size_t)j[s][r] * vstride + 16 * q + 4 * t4;
            const float4 vv =
                kSmemV ? lds_f4(reinterpret_cast<const float4*>(vp))
                       : ldg_f4(vp);
            hv[s][r] = make_float4(max_nan(uu[r][q].x + vv.x, 0.f),
                                   max_nan(uu[r][q].y + vv.y, 0.f),
                                   max_nan(uu[r][q].z + vv.z, 0.f),
                                   max_nan(uu[r][q].w + vv.w, 0.f));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = 2 * q + h;
          // A of slot s: a0 (row g, col t4), a1 (row g+8, col t4), a2 (row
          // g, col t4+4), a3 (row g+8, col t4+4)
          Split a[kSlots][4];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            a[s][0] = split(h ? hv[s][0].z : hv[s][0].x);
            a[s][1] = split(h ? hv[s][1].z : hv[s][1].x);
            a[s][2] = split(h ? hv[s][0].w : hv[s][0].y);
            a[s][3] = split(h ? hv[s][1].w : hv[s][1].y);
          }
#pragma unroll
          for (int nt = 0; nt < kTiles; ++nt) {
            const float4 w =
                lds_f4(ws + (kk * ntiles + nt0 + nt) * 32 + lane);
            const uint32_t wb0 = __float_as_uint(w.x);
            const uint32_t wb1 = __float_as_uint(w.y);
            const uint32_t ws0 = __float_as_uint(w.z);
            const uint32_t ws1 = __float_as_uint(w.w);
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              mma(acc[s][nt], a[s][0].small, a[s][1].small, a[s][2].small,
                  a[s][3].small, wb0, wb1);
              mma(acc[s][nt], a[s][0].fin, a[s][1].fin, a[s][2].fin,
                  a[s][3].fin, ws0, ws1);
              mma(acc[s][nt], a[s][0].big, a[s][1].big, a[s][2].big,
                  a[s][3].big, wb0, wb1);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            m[nt][e] = max_nan(m[nt][e], max_nan(acc[s][nt][e], 0.f));
          }
        }
      }
    }
    // accumulator element e: row g + 8 (e >> 1), column 2 t4 + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + 8 * r;
      if (p >= n) continue;
      float* o = out + (cloud + p) * c2;
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int col = (nt0 + nt) * 8 + 2 * t4;
        if (col < c2) {
          o[col] = m[nt][2 * r];
          if (col + 1 < c2) o[col + 1] = m[nt][2 * r + 1];
        }
      }
    }
  }
}

size_t smem_base(int c2) {  // B fragments and bias
  const size_t ntiles = (size_t)(c2 + 8 * kTiles - 1) / (8 * kTiles) * kTiles;
  return ntiles * kKSteps * 32 * sizeof(float4) + ntiles * 8 * sizeof(float);
}

template <bool kSmemV>
int launch(const float* u, const float* v, const long long* idx,
           const float* w2, const float* b2, int batch, int n, int k, int c1,
           int c2, float* out, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_stage_kernel<kSmemV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kStrip - 1) / kStrip, batch);
  edge_stage_kernel<kSmemV><<<grid, kThreads, smem, stream>>>(
      u, v, idx, w2, b2, n, k, c1, c2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v: (batch, n, 64) f32, channels past c1 zero; idx: (batch, n, k)
// int64 with entries in [0, n); w2: (c1, c2) f32 with c1 <= 64; b2: (c2,)
// f32; out: (batch, n, c2) f32; all on the device. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int edge_stage_launch(const float* u, const float* v,
                                 const long long* idx, const float* w2,
                                 const float* b2, int batch, int n, int k,
                                 int c1, int c2, float* out, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || k < 1 || k > n || c1 < 1 ||
      c1 > kC1 || c2 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t base = smem_base(c2);
  const size_t with_v = base + (size_t)n * kVStride * sizeof(float);
  if (with_v <= (size_t)kMaxSmem) {
    return launch<true>(u, v, idx, w2, b2, batch, n, k, c1, c2, out, with_v, s);
  }
  if (base <= (size_t)kMaxSmem) {
    return launch<false>(u, v, idx, w2, b2, batch, n, k, c1, c2, out, base, s);
  }
  return (int)cudaErrorInvalidValue;
}
