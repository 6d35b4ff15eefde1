// Fused DGCNN edge-conv stage for TRAINING, forward and backward, sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/edge_train_kernels.py
// (fused_edge_stage_train and its six Pallas passes _stats1, _stats2,
// _apply, _bwd2, _bwd_mid, _bwd_in). With U = x (P - Q) + b1 and
// V = x Q computed by the caller (w1 = [P; Q]), the stage is, over the
// edges (i, t) of every cloud, j = idx[i, t]:
//
//     pre1 = U_i + V_j          xhat1 = (pre1 - mu1) r1   h1 = relu(g1 xhat1 + be1)
//     pre2 = h1 W2 + b2         xhat2 = (pre2 - mu2) r2   h2 = relu(g2 xhat2 + be2)
//     out_i = max_t h2          r = rsqrt(var + eps)
//
// with (mu, var) the exact biased batch statistics over all B*N*k edges.
//
// What bounds it on Hopper: the k x C1 x C2 products on the FP32 pipes. At
// the training shape (256 clouds, N=512, k=20, C1=64, C2=128) one product
// pass is 42.9 GFLOP, 0.64 ms at 67 TFLOP/s, and the function needs 3: one
// forward (pre2) and two backward (dh1 = dpre2 W2^T, dW2 = h1^T dpre2),
// 1.9231 ms a forward+backward call. This design runs 4: bwd_mid rebuilds
// pre2 rather than store it, so that nothing of size (B, N, k, C2) reaches
// device memory (stored, pre2 would move ~2.7 GB, ~0.8 ms at 3.35 TB/s).
// The passes:
//
//   stats1    per-block channel sums of pre1 and pre1^2
//   fwd       product pass 1: per-block channel sums of pre2 and pre2^2,
//             and for every (point, channel) the pick of the max over k.
//             relu(BN2(.)) is monotone in pre2 per channel (r2 > 0): non-
//             decreasing where g2 > 0, non-increasing where g2 < 0 and
//             constant where g2 == 0. So the first t attaining the max of
//             h2 is the first argmax of pre2, the first argmin, or t = 0,
//             by the sign of g2, which is known before the statistics. The
//             pass writes pre2 at that t (into xs) and t (int32, into slot)
//   select    elementwise, no product: out = relu(g2 xhat2 + be2) and
//             xhat2 at the slot, from the pick and the BN2 table; h2 at the
//             pick is max_t h2 bit for bit (every rounding is monotone)
//   bwd2      per-block sums of dy2 and dy2 xhat2; dy2 is nonzero only at
//             the slot, so this reads out, xhat2 at the slot and dout only
//   bwd_mid   product passes 2-4: pre2 rebuilt, dpre2 = g2 r2 (dy2 - mean
//             dy2 - xhat2 mean(dy2 xhat2)) for every edge, then per-block
//             dW2, db2 and the BN1 sums of dy1 = (dpre2 W2^T) [h1 > 0]; it
//             stores dy1 for every edge, (B*N*k, C1) float32 (671 MB at the
//             training shape, 64-bit offsets: edge x C1 passes 2^31 at large
//             batches)
//   bwd_in    no product: dpre1 = g1 r1 (dy1 - mean dy1 - xhat1 mean(dy1
//             xhat1)) from the stored dy1 and xhat1 rebuilt from U, V and
//             idx; dU_i = sum_t dpre1 in registers, dV_j += dpre1 by global
//             atomicAdd
//   reduce    fixed-order sum of per-block partials
//
// The caller turns the reduced sums into (mu, var, r) and the BN means, as
// the JAX wrapper does between its passes. The max over k is routed on the
// integer slot map, never on recomputed values compared for equality (the
// JAX package's round-4 on-chip failure). The relu masks use h > 0, which
// equals y > 0 exactly, and out > 0 for the slot's y2 > 0. A call is 10
// launches: stats1, reduce, fwd, reduce, select forward; bwd2, reduce,
// bwd_mid, reduce, bwd_in backward.
//
// NaN propagates as in the plain version (torch.relu, the first argmax of
// stable_max) and the JAX kernel (jnp.maximum): every relu is max.NaN.f32
// (max_nan.cuh). The statistics are over the whole batch, so a NaN (or an
// infinity) anywhere in pre1 makes var1, and then every h1, pre2 and out,
// NaN, and one in pre2 makes var2 and its channel of out NaN, whatever the
// pick there.
//
// The batch is folded into gridDim.x (cloud x point block), so any batch
// runs in one launch a pass and the statistics stay over all of it.
//
// Determinism: every statistic and dW2/db2 is a per-block partial (each
// thread owns its accumulators) plus a fixed-order reduction, so two runs
// give bit-equal results. dV alone is scattered with global atomics:
// its sums, and df/dW1 after them, depend on the order the atomics land in
// and may differ between runs at rounding level.
//
// Precision: every product and every per-edge quantity is float32. The
// sums over all B*N*k edges (the BN statistics, the BN-backward sums, db2,
// and dW2 across the 4-point groups) accumulate in float64 and leave the
// reduction as float32: they cancel heavily (the BN-backward terms have
// mean zero by construction), and with 2.6 M edges a float32 running sum
// put the gradients 4x further from a float64 reference than the plain
// PyTorch twin's cascaded sums. The caller forms mu, var = E[x^2] - E[x]^2
// and the means in float32 from them, as the TPU kernel does.
//
// All math is float32 with FP32 FMAs (no TF32), as the TPU kernel's. The
// product passes use edge_stage.cu's layout: W2 in shared memory, 4 points
// staged at once with k edge rows each, 64 threads per point with 2
// columns and 10 edges in registers. dW2 is held in registers as a 4 x 8
// tile per thread; dh1 = dpre2 W2^T reads a row-padded W2 (stride C2p + 1)
// so that 32 channels of one column sit in 32 banks. bwd_in gives each
// thread 4 channels of one point (float4 loads of dy1 and V, one float4
// atomicAdd into dV an edge) where C1 is a multiple of 4.

#include <cuda_runtime.h>

#include <math_constants.h>

#include "max_nan.cuh"

namespace {

constexpr int kLanes = 64;   // threads per point
constexpr int kCols = 2;     // output channels per thread: j, j + kLanes
constexpr int kEdges = 10;   // edges accumulated together
constexpr int kGroup = 4;    // points staged at once, one team of kLanes each
constexpr int kThreads = kLanes * kGroup;
constexpr int kTileA = 4;    // dW2 tile of a thread: kTileA x kTileB
constexpr int kTileB = 8;
constexpr int kStatRows = 4;  // rows of the channel-sum kernels' blocks
constexpr int kMaxSmem = 232448;
constexpr long long kMaxBlocks = 2147483647LL;  // gridDim.x

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Shape {
  int n, k, c1, c2, c1p, c2p, ldw, rows;
  __host__ __device__ Shape(int n_, int k_, int c1_, int c2_)
      : n(n_), k(k_), c1(c1_), c2(c2_), c1p(round_up(c1_, 4)),
        c2p(round_up(c2_, kTileB)), ldw(round_up(c2_, kTileB) + 1),
        rows(kGroup * k_ + kEdges) {}
};

// The block's cloud (its first point's row) and first point: the batch is
// folded into gridDim.x, cloud-major, ceil(n / ppb) blocks a cloud
struct Strip {
  size_t cloud;
  int p_base;
  __device__ Strip(int n, int ppb) {
    const int per = (n + ppb - 1) / ppb;
    cloud = (size_t)(blockIdx.x / per) * n;
    p_base = (int)(blockIdx.x % per) * ppb;
  }
};

// bn tables are (4, C) row-major: mu, r = rsqrt(var + eps), gamma, beta
__device__ inline void load_w2(const float* __restrict__ w2, float* w2s,
                               const Shape& s) {
  for (int e = threadIdx.x; e < s.c1p * s.ldw; e += kThreads) {
    const int r = e / s.ldw, c = e % s.ldw;
    w2s[e] = (r < s.c1 && c < s.c2) ? w2[r * s.c2 + c] : 0.f;
  }
}

// h1 (and xhat1) of the edge rows of points p0 .. p0 + np - 1; rows past
// np * k are zero
__device__ inline void stage_h1(const float* __restrict__ u,
                                const float* __restrict__ v,
                                const long long* __restrict__ idx,
                                const float* __restrict__ bn1, size_t cloud,
                                int p0, int np, const Shape& s, float* h1s,
                                float* xh1s) {
  for (int e = threadIdx.x; e < s.rows * s.c1p; e += kThreads) {
    const int r = e / s.c1p, c = e % s.c1p;
    float h = 0.f, xh = 0.f;
    if (r < np * s.k && c < s.c1) {
      const size_t i = cloud + p0 + r / s.k;
      const long long j = idx[i * s.k + r % s.k];
      const float pre = u[i * s.c1 + c] + v[(cloud + j) * s.c1 + c];
      xh = (pre - bn1[c]) * bn1[s.c1 + c];
      h = max_nan(xh * bn1[2 * s.c1 + c] + bn1[3 * s.c1 + c], 0.f);
    }
    h1s[e] = h;
    if (xh1s != nullptr) xh1s[e] = xh;
  }
}

// acc[e][q] = sum_c h1[row0 + e][c] W2[c][col[q]] for kEdges edge rows
__device__ inline void edge_products(const float* hrow, const float* w2s,
                                     const Shape& s, const int col[kCols],
                                     float acc[kEdges][kCols]) {
#pragma unroll
  for (int e = 0; e < kEdges; ++e) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[e][q] = 0.f;
  }
  for (int c = 0; c < s.c1p; c += 4) {
    float w[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) w[r][q] = w2s[(c + r) * s.ldw + col[q]];
    }
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      const float4 h = *reinterpret_cast<const float4*>(hrow + e * s.c1p + c);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        acc[e][q] = fmaf(h.x, w[0][q], acc[e][q]);
        acc[e][q] = fmaf(h.y, w[1][q], acc[e][q]);
        acc[e][q] = fmaf(h.z, w[2][q], acc[e][q]);
        acc[e][q] = fmaf(h.w, w[3][q], acc[e][q]);
      }
    }
  }
}

// the columns of one column pass: jb + lane, jb + lane + kLanes
__device__ inline void pass_cols(int jb, int lane, int c2, int col[kCols],
                                 bool ok[kCols]) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int j = jb + lane + q * kLanes;
    ok[q] = j < c2;
    col[q] = ok[q] ? j : c2 - 1;  // idle lanes read a valid column
  }
}

// ------------------------------------------------------------------ stats

// Row values of the two channel-sum passes: (a, b) of row e, channel c.
// pre1 = U_i + V_j of edge e, and its square (the f32 square)
struct Pre1Row {
  const float* u;
  const float* v;
  const long long* idx;
  int n, k, c1;
  __device__ float2 operator()(long long e, int c) const {
    const long long i = e / k;
    const long long cloud = i / n * n;
    const float x = u[i * c1 + c] + v[(cloud + idx[e]) * c1 + c];
    return make_float2(x, x * x);
  }
};

// dy2 = dout [out > 0] at point i's slot, and dy2 xhat2 (the f32 product)
struct Dy2Row {
  const float* dout;
  const float* out;
  const float* xs;
  int c2;
  __device__ float2 operator()(long long i, int c) const {
    const size_t at = (size_t)i * c2 + c;
    const float dy = out[at] > 0.f ? dout[at] : 0.f;
    return make_float2(dy, dy * xs[at]);
  }
};

// Channel sums of (a, b) = row(e, c) over the block's rows
// [blk * rows_per_block, ...), in f64: part[blk] = (sum a[c], sum b[c]).
// Each of kStatRows thread rows sums a strided row subset in order, then
// the thread rows are added in order: a fixed order, run to run.
template <typename Row>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(Row row, long long rows, int channels,
                    int rows_per_block, double* __restrict__ part) {
  __shared__ double red[kStatRows][2][kLanes];
  const int lane = threadIdx.x % kLanes, r = threadIdx.x / kLanes;
  const long long e0 = (long long)blockIdx.x * rows_per_block;
  const long long e1 = min(e0 + rows_per_block, rows);
  for (int cb = 0; cb < channels; cb += kLanes) {
    const int c = cb + lane;
    double sa = 0.0, sb = 0.0;
    if (c < channels) {
      for (long long e = e0 + r; e < e1; e += kStatRows) {
        const float2 ab = row(e, c);
        sa += ab.x;
        sb += ab.y;
      }
    }
    red[r][0][lane] = sa;
    red[r][1][lane] = sb;
    __syncthreads();
    if (r == 0 && c < channels) {
      double a = 0.0, b = 0.0;
      for (int q = 0; q < kStatRows; ++q) {
        a += red[q][0][lane];
        b += red[q][1][lane];
      }
      part[(size_t)blockIdx.x * 2 * channels + c] = a;
      part[(size_t)blockIdx.x * 2 * channels + channels + c] = b;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward

// Product pass 1: part[blk] = (sum pre2[c2], sum pre2^2[c2]); for every
// (point, channel), pre2 at the pick (into xs) and its t (into slot): the
// first t with the largest sg pre2, sg = sign(g2) (-1, 0 or +1)
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
           const long long* __restrict__ idx, const float* __restrict__ bn1,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ g2, int n, int k, int c1, int c2,
           int ppb, int* __restrict__ slot, float* __restrict__ xs,
           double* __restrict__ part) {
  extern __shared__ float4 smem_f4[];
  const Shape s(n, k, c1, c2);
  double* const cs = reinterpret_cast<double*>(smem_f4);  // (kGroup, 2, c2)
  float* const w2s = reinterpret_cast<float*>(cs + kGroup * 2 * c2);
  float* const h1s = w2s + s.c1p * s.ldw;
  const int tid = threadIdx.x, p = tid / kLanes, lane = tid % kLanes;
  const Strip strip(n, ppb);
  load_w2(w2, w2s, s);
  for (int e = tid; e < kGroup * 2 * c2; e += kThreads) cs[e] = 0.0;

  for (int g = 0; g < ppb; g += kGroup) {
    const int p0 = strip.p_base + g;
    if (p0 >= n) break;  // uniform across the block
    const int np = min(kGroup, n - p0);
    __syncthreads();
    stage_h1(u, v, idx, bn1, strip.cloud, p0, np, s, h1s, nullptr);
    __syncthreads();
    for (int jb = 0; p < np && jb < c2; jb += kLanes * kCols) {
      int col[kCols];
      bool ok[kCols];
      pass_cols(jb, lane, c2, col, ok);
      double sum[kCols] = {}, sq[kCols] = {};
      float sg[kCols], best[kCols], pick[kCols];
      int pt[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float gq = g2[col[q]];
        sg[q] = gq > 0.f ? 1.f : (gq < 0.f ? -1.f : 0.f);
        best[q] = -CUDART_INF_F;
        pick[q] = 0.f;
        pt[q] = 0;
      }
      for (int t0 = 0; t0 < k; t0 += kEdges) {
        float acc[kEdges][kCols];
        edge_products(h1s + (p * k + t0) * s.c1p, w2s, s, col, acc);
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (t0 + e < k) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              const float x = acc[e][q] + b2[col[q]];
              sum[q] += x;
              sq[q] += x * x;
              // strict: the first t; sg = 0 keeps t = 0 (for finite x)
              const float y = sg[q] * x;
              if (y > best[q]) {
                best[q] = y;
                pick[q] = x;
                pt[q] = t0 + e;
              }
            }
          }
        }
      }
      const size_t at = (strip.cloud + p0 + p) * c2;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (ok[q]) {
          cs[(p * 2) * c2 + col[q]] += sum[q];
          cs[(p * 2 + 1) * c2 + col[q]] += sq[q];
          xs[at + col[q]] = pick[q];
          slot[at + col[q]] = pt[q];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * c2; e += kThreads) {
    double a = 0.0;
    for (int q = 0; q < kGroup; ++q) a += cs[q * 2 * c2 + e];
    part[(size_t)blockIdx.x * 2 * c2 + e] = a;
  }
}

// out = relu(g2 xhat2 + be2) and xs = xhat2 = (pre2 - mu2) r2 at the pick,
// which xs holds on entry; one thread an element
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ bn2, long long total, int c2,
              float* __restrict__ xs, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % c2);
  const float xh = (xs[e] - bn2[c]) * bn2[c2 + c];
  out[e] = max_nan(xh * bn2[2 * c2 + c] + bn2[3 * c2 + c], 0.f);
  xs[e] = xh;
}

// --------------------------------------------------------------- backward

// dpre2 of the team's point for every edge row into dp2s (row stride c2p);
// adds sum_t dpre2 to db2s[p][c] when db2s is given.
__device__ inline void dpre2_rows(const float* h1s, const float* w2s,
                                  const float* __restrict__ b2,
                                  const float* __restrict__ bn2,
                                  const int* __restrict__ slot,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ out,
                                  const float* __restrict__ m2, size_t i,
                                  int p, int lane, const Shape& s,
                                  float* dp2s, double* db2s) {
  const int c2 = s.c2, k = s.k;
  for (int jb = 0; jb < c2; jb += kLanes * kCols) {
    int col[kCols];
    bool ok[kCols];
    pass_cols(jb, lane, c2, col, ok);
    int sl[kCols];
    float go[kCols];
    double db[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const size_t at = i * c2 + col[q];
      sl[q] = slot[at];
      go[q] = out[at] > 0.f ? dout[at] : 0.f;
      db[q] = 0.0;
    }
    for (int t0 = 0; t0 < k; t0 += kEdges) {
      float acc[kEdges][kCols];
      edge_products(h1s + (p * k + t0) * s.c1p, w2s, s, col, acc);
#pragma unroll
      for (int e = 0; e < kEdges; ++e) {
        const int t = t0 + e;
        if (t < k) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const int c = col[q];
            const float xh = (acc[e][q] + b2[c] - bn2[c]) * bn2[c2 + c];
            const float dy = t == sl[q] ? go[q] : 0.f;
            const float a2 = bn2[2 * c2 + c] * bn2[c2 + c];
            const float dp = a2 * (dy - m2[c] - xh * m2[c2 + c]);
            if (ok[q]) dp2s[(p * k + t) * s.c2p + c] = dp;
            db[q] += dp;
          }
        }
      }
    }
    if (db2s != nullptr) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (ok[q]) db2s[p * c2 + col[q]] += db[q];
      }
    }
  }
}

// dh1[e] = sum_c2 dpre2[row0 + e][c2] W2[cc][c2] for kEdges edge rows
__device__ inline void dh1_rows(const float* dprow, const float* w2s,
                                const Shape& s, int cc, float dh[kEdges]) {
#pragma unroll
  for (int e = 0; e < kEdges; ++e) dh[e] = 0.f;
  const float* wrow = w2s + cc * s.ldw;
  for (int c = 0; c < s.c2p; c += 4) {
    const float w0 = wrow[c], w1 = wrow[c + 1], w2 = wrow[c + 2],
                w3 = wrow[c + 3];
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      const float4 d = *reinterpret_cast<const float4*>(dprow + e * s.c2p + c);
      dh[e] = fmaf(d.x, w0, dh[e]);
      dh[e] = fmaf(d.y, w1, dh[e]);
      dh[e] = fmaf(d.z, w2, dh[e]);
      dh[e] = fmaf(d.w, w3, dh[e]);
    }
  }
}

// shared memory of bwd_mid: W2 (row-padded), h1, xhat1 and dpre2 rows,
// after its float64 accumulators (the dW2 tiles, then db2 and the BN1 sums
// per team)
__host__ __device__ inline size_t mid_floats(const Shape& s) {
  return (size_t)s.c1p * s.ldw + 2 * (size_t)s.rows * s.c1p +
         (size_t)s.rows * s.c2p;
}

__host__ __device__ inline size_t mid_doubles(const Shape& s) {
  // even, so that the floats after them start 16-byte aligned
  return (size_t)kThreads * kTileA * kTileB +
         kGroup * ((size_t)s.c2 + 2 * s.c1);
}

// Product passes 2-4: part[blk] = (dW2[c1][c2], db2[c2], sum dy1[c1],
// sum dy1 xhat1[c1]), and dy1 (edges, c1) for every edge
__global__ void __launch_bounds__(kThreads)
bwd_mid_kernel(const float* __restrict__ u, const float* __restrict__ v,
               const long long* __restrict__ idx,
               const float* __restrict__ bn1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ bn2,
               const int* __restrict__ slot, const float* __restrict__ dout,
               const float* __restrict__ out, const float* __restrict__ m2,
               int n, int k, int c1, int c2, int ppb,
               float* __restrict__ dy1, double* __restrict__ part) {
  extern __shared__ float4 smem_f4[];
  const Shape s(n, k, c1, c2);
  double* const dws = reinterpret_cast<double*>(smem_f4);  // per-thread tile
  double* const db2s = dws + kThreads * kTileA * kTileB;   // (kGroup, c2)
  double* const s1s = db2s + kGroup * c2;                  // (kGroup, 2, c1)
  float* const w2s = reinterpret_cast<float*>(dws + mid_doubles(s));
  float* const h1s = w2s + s.c1p * s.ldw;
  float* const xh1s = h1s + s.rows * s.c1p;
  float* const dp2s = xh1s + s.rows * s.c1p;
  const int tid = threadIdx.x, p = tid / kLanes, lane = tid % kLanes;
  const Strip strip(n, ppb);
  load_w2(w2, w2s, s);
  for (int e = tid; e < s.rows * s.c2p; e += kThreads) dp2s[e] = 0.f;
  for (int e = tid; e < (int)mid_doubles(s); e += kThreads) dws[e] = 0.0;

  // this thread's dW2 tile
  const int nb = s.c2p / kTileB;
  const bool has_tile = tid < (s.c1p / kTileA) * nb;
  const int ta = has_tile ? tid / nb * kTileA : 0;
  const int tb = has_tile ? tid % nb * kTileB : 0;
  double* const dwt = dws + tid * kTileA * kTileB;

  for (int g = 0; g < ppb; g += kGroup) {
    const int p0 = strip.p_base + g;
    if (p0 >= n) break;
    const int np = min(kGroup, n - p0);
    __syncthreads();
    stage_h1(u, v, idx, bn1, strip.cloud, p0, np, s, h1s, xh1s);
    __syncthreads();
    const size_t i = strip.cloud + p0 + p;
    if (p < np) {
      dpre2_rows(h1s, w2s, b2, bn2, slot, dout, out, m2, i, p, lane, s, dp2s,
                 db2s);
    }
    __syncthreads();
    // dy1 = dh1 [h1 > 0], stored, and its BN1 sums (team = point, lane =
    // channel)
    for (int cc = lane; p < np && cc < c1; cc += kLanes) {
      double sa = 0.0, sb = 0.0;
      for (int t0 = 0; t0 < k; t0 += kEdges) {
        float dh[kEdges];
        dh1_rows(dp2s + (p * k + t0) * s.c2p, w2s, s, cc, dh);
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (t0 + e < k) {
            const int at = (p * k + t0 + e) * s.c1p + cc;
            const float dy = h1s[at] > 0.f ? dh[e] : 0.f;
            dy1[(i * k + t0 + e) * c1 + cc] = dy;
            sa += dy;
            sb += dy * xh1s[at];  // the f32 product, summed in f64
          }
        }
      }
      s1s[(p * 2) * c1 + cc] += sa;
      s1s[(p * 2 + 1) * c1 + cc] += sb;
    }
    // dW2 += h1^T dpre2: the group's edge rows in f32 registers, then
    // into the thread's f64 tile
    if (has_tile) {
      float dw[kTileA][kTileB];
#pragma unroll
      for (int a = 0; a < kTileA; ++a) {
#pragma unroll
        for (int b = 0; b < kTileB; ++b) dw[a][b] = 0.f;
      }
      for (int e = 0; e < np * k; ++e) {
        const float4 h = *reinterpret_cast<const float4*>(h1s + e * s.c1p + ta);
        const float4 d0 = *reinterpret_cast<const float4*>(dp2s + e * s.c2p + tb);
        const float4 d1 =
            *reinterpret_cast<const float4*>(dp2s + e * s.c2p + tb + 4);
        const float ha[kTileA] = {h.x, h.y, h.z, h.w};
        const float db[kTileB] = {d0.x, d0.y, d0.z, d0.w,
                                  d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int a = 0; a < kTileA; ++a) {
#pragma unroll
          for (int b = 0; b < kTileB; ++b) dw[a][b] = fmaf(ha[a], db[b], dw[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < kTileA; ++a) {
#pragma unroll
        for (int b = 0; b < kTileB; ++b) dwt[a * kTileB + b] += dw[a][b];
      }
    }
  }
  __syncthreads();
  const size_t cols = (size_t)c1 * c2 + c2 + 2 * c1;
  double* const row = part + (size_t)blockIdx.x * cols;
  if (has_tile) {
    for (int a = 0; a < kTileA; ++a) {
      for (int b = 0; b < kTileB; ++b) {
        if (ta + a < c1 && tb + b < c2) {
          row[(size_t)(ta + a) * c2 + tb + b] = dwt[a * kTileB + b];
        }
      }
    }
  }
  for (int c = tid; c < c2; c += kThreads) {
    double a = 0.0;
    for (int q = 0; q < kGroup; ++q) a += db2s[q * c2 + c];
    row[(size_t)c1 * c2 + c] = a;
  }
  for (int c = tid; c < 2 * c1; c += kThreads) {
    const int which = c / c1, ch = c % c1;
    double a = 0.0;
    for (int q = 0; q < kGroup; ++q) a += s1s[(q * 2 + which) * c1 + ch];
    row[(size_t)c1 * c2 + c2 + c] = a;
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& x, int) { return x; }
  __device__ static void set(T& x, int, float a) { x = a; }
  __device__ static void add(float* at, const T& x) { atomicAdd(at, x); }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& x, int q) {
    return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
  }
  __device__ static void set(T& x, int q, float a) {
    if (q == 0) x.x = a;
    else if (q == 1) x.y = a;
    else if (q == 2) x.z = a;
    else x.w = a;
  }
  // one 16-byte vector reduction (sm_90)
  __device__ static void add(float* at, const T& x) {
    atomicAdd(reinterpret_cast<float4*>(at), x);
  }
};

// dpre1 = g1 r1 (dy1 - mean dy1 - xhat1 mean(dy1 xhat1)) for every edge,
// with xhat1 = (U_i + V_j - mu1) r1 rebuilt as stage_h1 does; du_i = sum_t
// dpre1 (in order, in registers), dv_j += dpre1 (global atomics). A thread
// holds VEC channels of one point; m1 is (2, c1): mean dy1, mean dy1 xhat1
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_in_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const long long* __restrict__ idx,
              const float* __restrict__ bn1, const float* __restrict__ m1,
              const float* __restrict__ dy1, long long points, int n, int k,
              int c1, float* __restrict__ du, float* __restrict__ dv) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int groups = c1 / VEC;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= points * groups) return;
  const long long i = gid / groups;
  const int c0 = (int)(gid % groups) * VEC;
  const long long cloud = i / n * n;
  const T ui = *reinterpret_cast<const T*>(u + i * c1 + c0);
  float mu[VEC], r[VEC], a1[VEC], ma[VEC], mb[VEC], acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const int c = c0 + q;
    mu[q] = bn1[c];
    r[q] = bn1[c1 + c];
    a1[q] = bn1[2 * c1 + c] * bn1[c1 + c];
    ma[q] = m1[c];
    mb[q] = m1[c1 + c];
    acc[q] = 0.f;
  }
  for (int t = 0; t < k; ++t) {
    const long long j = idx[i * k + t];
    const T vj = *reinterpret_cast<const T*>(v + (cloud + j) * c1 + c0);
    const T dy = *reinterpret_cast<const T*>(dy1 + (i * k + t) * c1 + c0);
    T dp;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float pre = V::get(ui, q) + V::get(vj, q);
      const float xh = (pre - mu[q]) * r[q];
      const float d = a1[q] * (V::get(dy, q) - ma[q] - xh * mb[q]);
      acc[q] += d;
      V::set(dp, q, d);
    }
    V::add(dv + (cloud + j) * c1 + c0, dp);
  }
  T a;
#pragma unroll
  for (int q = 0; q < VEC; ++q) V::set(a, q, acc[q]);
  *reinterpret_cast<T*>(du + i * c1 + c0) = a;
}

// out[c] = sum over rows, in row order within each of kStatRows strided
// lanes and then over the lanes in order: a fixed order, run to run
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ part, int rows, int cols,
              float* __restrict__ out) {
  __shared__ double red[kThreads / 32][32];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  double a = 0.0;
  if (c < cols) {
    for (int r = ty; r < rows; r += kThreads / 32) a += part[(size_t)r * cols + c];
  }
  red[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && c < cols) {
    double t = 0.0;
    for (int q = 0; q < kThreads / 32; ++q) t += red[q][tx];
    out[c] = (float)t;
  }
}

bool bad_shape(int batch, int n, int k, int c1, int c2, int ppb) {
  return batch < 1 || n < 1 || k < 1 || k > n || c1 < 1 || c2 < 1 ||
         ppb < kGroup || ppb % kGroup != 0 ||
         (long long)batch * ((n + ppb - 1) / ppb) > kMaxBlocks;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

unsigned strips(int batch, int n, int ppb) {
  return (unsigned)((long long)batch * ((n + ppb - 1) / ppb));
}

}  // namespace

// All pointers are device pointers of contiguous float32 tensors (idx:
// int64 in [0, n); slot: int32); bn tables (4, C), m tables (2, C). Each
// launcher returns the CUDA error code of its launch (0 on success).
// Partial buffers (float64) hold one row per block: stats1 ceil(batch*n*k / rpb)
// rows of 2*c1, bwd2 ceil(batch*n / rpb) rows of 2*c2, fwd
// batch*ceil(n / ppb) rows of 2*c2, bwd_mid batch*ceil(n / ppb) rows of
// c1*c2 + c2 + 2*c1.

extern "C" int edge_train_stats1_launch(const float* u, const float* v,
                                        const long long* idx, int batch,
                                        int n, int k, int c1, int rpb,
                                        double* part, void* stream) {
  if (bad_shape(batch, n, k, c1, 1, kGroup) || rpb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long edges = (long long)batch * n * k;
  const long long blocks = (edges + rpb - 1) / rpb;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  channel_sums_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Pre1Row{u, v, idx, n, k, c1}, edges, c1, rpb, part);
  return (int)cudaGetLastError();
}

// g2: (c2,), the BN2 scale, whose sign picks the max or the min; slot:
// (batch, n, c2) int32 and xs: (batch, n, c2) f32, the pick's t and pre2
extern "C" int edge_train_fwd_launch(const float* u, const float* v,
                                     const long long* idx, const float* bn1,
                                     const float* w2, const float* b2,
                                     const float* g2, int batch, int n,
                                     int k, int c1, int c2, int ppb,
                                     int* slot, float* xs, double* part,
                                     void* stream) {
  if (bad_shape(batch, n, k, c1, c2, ppb)) return (int)cudaErrorInvalidValue;
  const Shape s(n, k, c1, c2);
  const size_t smem =
      ((size_t)s.c1p * s.ldw + (size_t)s.rows * s.c1p) * sizeof(float) +
      (size_t)kGroup * 2 * s.c2 * sizeof(double);
  cudaError_t err = set_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<strips(batch, n, ppb), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      u, v, idx, bn1, w2, b2, g2, n, k, c1, c2, ppb, slot, xs, part);
  return (int)cudaGetLastError();
}

// bn2: the (4, c2) BN2 table; xs: the pick's pre2 in, xhat2 out; out:
// (batch, n, c2) f32
extern "C" int edge_train_select_launch(const float* bn2, int batch, int n,
                                        int c2, float* xs, float* out,
                                        void* stream) {
  if (batch < 1 || n < 1 || c2 < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)batch * n * c2;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  select_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(bn2, total, c2, xs,
                                                       out);
  return (int)cudaGetLastError();
}

extern "C" int edge_train_bwd2_launch(const float* dout, const float* out,
                                      const float* xs, int batch, int n,
                                      int c2, int rpb, double* part,
                                      void* stream) {
  if (batch < 1 || n < 1 || c2 < 1 || rpb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long points = (long long)batch * n;
  const long long blocks = (points + rpb - 1) / rpb;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  channel_sums_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Dy2Row{dout, out, xs, c2}, points, c2, rpb, part);
  return (int)cudaGetLastError();
}

// dy1: (batch * n * k, c1) f32, written for every edge
extern "C" int edge_train_bwd_mid_launch(
    const float* u, const float* v, const long long* idx, const float* bn1,
    const float* w2, const float* b2, const float* bn2, const int* slot,
    const float* dout, const float* out, const float* m2, int batch, int n,
    int k, int c1, int c2, int ppb, float* dy1, double* part, void* stream) {
  if (bad_shape(batch, n, k, c1, c2, ppb)) return (int)cudaErrorInvalidValue;
  const Shape s(n, k, c1, c2);
  if ((s.c1p / kTileA) * (s.c2p / kTileB) > kThreads) {
    return (int)cudaErrorInvalidValue;  // dW2 needs one tile a thread
  }
  const size_t smem =
      mid_floats(s) * sizeof(float) + mid_doubles(s) * sizeof(double);
  cudaError_t err = set_smem(bwd_mid_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_mid_kernel<<<strips(batch, n, ppb), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      u, v, idx, bn1, w2, b2, bn2, slot, dout, out, m2, n, k, c1, c2, ppb,
      dy1, part);
  return (int)cudaGetLastError();
}

// bn1: the (4, c1) BN1 table; m1: (2, c1); dy1 as bwd_mid wrote it; du:
// (batch, n, c1) f32, written; dv: (batch, n, c1) f32, zeroed by the caller
extern "C" int edge_train_bwd_in_launch(const float* u, const float* v,
                                        const long long* idx,
                                        const float* bn1, const float* m1,
                                        const float* dy1, int batch, int n,
                                        int k, int c1, float* du, float* dv,
                                        void* stream) {
  if (bad_shape(batch, n, k, c1, 1, kGroup)) return (int)cudaErrorInvalidValue;
  const long long points = (long long)batch * n;
  const int vec = c1 % 4 == 0 ? 4 : 1;
  const long long blocks = (points * (c1 / vec) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    bwd_in_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(
        u, v, idx, bn1, m1, dy1, points, n, k, c1, du, dv);
  } else {
    bwd_in_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(
        u, v, idx, bn1, m1, dy1, points, n, k, c1, du, dv);
  }
  return (int)cudaGetLastError();
}

extern "C" int edge_train_reduce_launch(const double* part, int rows,
                                        int cols, float* out, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(cols + 31) / 32, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}
