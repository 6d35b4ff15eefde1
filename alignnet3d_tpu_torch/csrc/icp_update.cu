// One iteration's pose update of constrained point-to-point ICP, for sm_90a.
//
// Replaces no Pallas kernel. The JAX package runs the ICP loop as one
// lax.scan under jit (alignnet3d_tpu/icp/p2point.py: _icp_single), and XLA
// fuses the scan's body; the port's eager loop lost that fusion and paid
// some 60 small float64 operations an iteration on the host
// (icp/p2point.py: icp_update_plain, the plain version of this kernel). An
// ICP iteration on the card is now the nearest-neighbour sweep (kernel 2)
// and one launch of this kernel, which takes the sweep's (idx, d2) to the
// next sweep's input (the first sweep's input is one eager transform a
// loop):
//
//     moved = R src + t                         (float64, from src)
//     w     = src_mask & (d2 < radius2)          (compared in float32)
//     q     = dst[idx]                           (float32, widened exactly)
//     p_bar, q_bar = sum(w moved) / W, sum(w q) / W,   W = max(sum w, 1e-12)
//     a, b  = moved - p_bar, q - q_bar
//     yaw   = atan2(sum w (a0 b1 - a1 b0), sum w (a0 b0 + a1 b1))
//     R_inc = Rz(yaw), t_inc = q_bar - R_inc p_bar
//     R, t  = R_inc R, R_inc t + t_inc           (in place; kept if sum w = 0)
//     moved32 = f32(R src + t)                   (the next sweep's points)
//
// Each elementwise product, sum and difference is rounded on its own
// (__dmul_rn / __dadd_rn: no contraction into FMAs), as the plain version
// rounds them; only the order of the sums over points differs. A zero
// weight still multiplies its point, so a non-finite coordinate anywhere in
// a pair's padded cloud spoils that pair's sums as it does in the plain
// version.
//
// One block a pair; pairs are independent. Every sum over points is a
// fixed-order tree (each thread's strided partial sum, then shuffles inside
// a warp, then the warps' sums in warp 0), with no atomics: a pair's answer
// is the same from run to run and at any batch size or padding beyond its
// points (padding adds exact zeros).
//
// What bounds it on the H100: bytes, about 61 a point an iteration (src
// 24, dst 12, idx 8, d2 4, mask 1, moved32 12), about 16 MB at 64 pairs of
// 4,096 points: 4.8 us at 3.35 TB/s. At the tracker's batch (1-64 pairs)
// the card is far from that; what the kernel removes is the host's dispatch
// of the eager chain and its intermediate tensors (moved, w, q, a, b and
// their products, each written to and read back from device memory). The
// design reads each input from device memory once: the second and third
// passes re-read a pair's src and gathered dst, ~0.2 MB a pair, from L2.
// dst is read as float32, half the bytes of a float64 copy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // a pair's block: 8 points a thread at 4,096
constexpr int kWarps = kThreads / 32;

// v summed over the block in a fixed order; every thread gets the totals.
// scratch holds N * kWarps doubles.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = __dadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = lane < kWarps ? scratch[k * kWarps + lane] : 0.0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        v[k] = __dadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) scratch[k * kWarps] = v[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = scratch[k * kWarps];
  __syncthreads();  // scratch is free for the next sum
}

// x - y, rounded once
__device__ __forceinline__ double dsub(double x, double y) {
  return __dadd_rn(x, -y);
}

// m = ((R[e][0] x + R[e][1] y) + R[e][2] z) + t[e], each step rounded
__device__ __forceinline__ void transform(const double* R, const double* t,
                                          double x, double y, double z,
                                          double* m) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    m[e] = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(R[3 * e], x),
                                         __dmul_rn(R[3 * e + 1], y)),
                               __dmul_rn(R[3 * e + 2], z)),
                     t[e]);
  }
}

__global__ void __launch_bounds__(kThreads)
icp_update_kernel(const double* __restrict__ src,
                  const unsigned char* __restrict__ src_mask,
                  const float* __restrict__ dst,
                  const long long* __restrict__ idx,
                  const float* __restrict__ d2, float radius2, int n, int n2,
                  double* R_io, double* t_io,
                  float* __restrict__ moved32) {
  __shared__ double scratch[7 * kWarps];
  const int pair = blockIdx.x;
  const size_t row0 = static_cast<size_t>(pair) * n;
  const double* s = src + row0 * 3;
  R_io += static_cast<size_t>(pair) * 9;
  t_io += static_cast<size_t>(pair) * 3;
  double R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R_io[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = t_io[k];

  const float* q_pts = dst + static_cast<size_t>(pair) * n2 * 3;
  // the moved point, weight and correspondence of point i
  auto point = [&](int i, double* m, double& w, double* q) {
    transform(R, t, s[3 * i], s[3 * i + 1], s[3 * i + 2], m);
    w = (src_mask[row0 + i] && d2[row0 + i] < radius2) ? 1.0 : 0.0;
    // nn_argmin's indices lie in [0, n2); the clamp only keeps a bad one
    // inside the pair's cloud
    long long j = idx[row0 + i];
    j = j < 0 ? 0 : (j >= n2 ? n2 - 1 : j);
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = static_cast<double>(q_pts[3 * j + k]);
  };

  // pass 1: the weight and the weighted sums of moved and q
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double m[3], w, q[3];
    point(i, m, w, q);
    acc[0] = __dadd_rn(acc[0], w);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc[1 + k] = __dadd_rn(acc[1 + k], __dmul_rn(w, m[k]));
      acc[4 + k] = __dadd_rn(acc[4 + k], __dmul_rn(w, q[k]));
    }
  }
  block_sum(acc, scratch);
  const double wsum = fmax(acc[0], 1e-12);
  double p_bar[3], q_bar[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p_bar[k] = __ddiv_rn(acc[1 + k], wsum);
    q_bar[k] = __ddiv_rn(acc[4 + k], wsum);
  }

  // pass 2: the cross sums of the centred points
  double cross[2] = {0.0, 0.0};  // num, den
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double m[3], w, q[3];
    point(i, m, w, q);
    const double a0 = dsub(m[0], p_bar[0]), a1 = dsub(m[1], p_bar[1]);
    const double b0 = dsub(q[0], q_bar[0]), b1 = dsub(q[1], q_bar[1]);
    const double num = dsub(__dmul_rn(a0, b1), __dmul_rn(a1, b0));
    const double den = __dadd_rn(__dmul_rn(a0, b0), __dmul_rn(a1, b1));
    cross[0] = __dadd_rn(cross[0], __dmul_rn(w, num));
    cross[1] = __dadd_rn(cross[1], __dmul_rn(w, den));
  }
  block_sum(cross, scratch);

  // every thread composes the same new pose from the same totals
  if (acc[0] > 0.0) {
    double sn, cs;
    sincos(atan2(cross[0], cross[1]), &sn, &cs);
    const double Ri[9] = {cs, -sn, 0.0, sn, cs, 0.0, 0.0, 0.0, 1.0};
    double Rn[9], tn[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const double* row = Ri + 3 * r;
      const double t_inc = dsub(
          q_bar[r], __dadd_rn(__dadd_rn(__dmul_rn(row[0], p_bar[0]),
                                        __dmul_rn(row[1], p_bar[1])),
                              __dmul_rn(row[2], p_bar[2])));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Rn[3 * r + c] = __dadd_rn(__dadd_rn(__dmul_rn(row[0], R[c]),
                                            __dmul_rn(row[1], R[3 + c])),
                                  __dmul_rn(row[2], R[6 + c]));
      }
      tn[r] = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(row[0], t[0]),
                                            __dmul_rn(row[1], t[1])),
                                  __dmul_rn(row[2], t[2])),
                        t_inc);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = tn[k];
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R_io[k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t_io[k] = t[k];
    }
  }

  // pass 3: the next sweep's points
  float* out = moved32 + row0 * 3;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double m[3];
    transform(R, t, s[3 * i], s[3 * i + 1], s[3 * i + 2], m);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[3 * i + k] = __double2float_rn(m[k]);
  }
}

}  // namespace

// src: (batch, n, 3) f64; src_mask: (batch, n) bool; dst: (batch, n2, 3)
// f32; idx: (batch, n) int64 and d2: (batch, n) f32, nn_argmin's answer
// for moved32; R: (batch, 3, 3) f64 and t: (batch, 3) f64, updated in
// place; moved32: (batch, n, 3) f32, written. All on the device,
// contiguous. Returns the CUDA error code of the launch.
extern "C" int icp_update_launch(const double* src,
                                 const unsigned char* src_mask,
                                 const float* dst, const long long* idx,
                                 const float* d2, float radius2, int batch,
                                 int n, int n2, double* R,
                                 double* t, float* moved32, void* stream) {
  if (batch < 1 || n < 1 || n2 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  icp_update_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_mask, dst, idx, d2, radius2, n, n2, R, t, moved32);
  return (int)cudaGetLastError();
}
