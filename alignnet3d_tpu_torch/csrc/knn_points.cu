// Exact k-nearest neighbours within each point cloud, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/knn_kernels.py
// (knn_points_pallas / _knn_kernel), the graph build of the DGCNN
// backbone. For every point a of cloud b it writes the indices of the k
// points q of the same cloud with the smallest
//
//     d2(a, q) = (|a|^2 - 2 a.q) + |q|^2,
//
// in ascending order, ties to the lower index: the order of
// lax.top_k(-d2). The cross term is summed as ((a0 q0' + a1 q1') + a2 q2')
// with q' = -2 q, which is -2 a.q exactly, and every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn: no contraction into FMAs), in
// the order the plain PyTorch version knn_points_plain evaluates them, so
// the two agree bit for bit. Exact duplicate points (a resampled cloud of
// few points has many) give bit-equal distances, and the index order
// settles them.
//
// What bounds it on Hopper: FP32 arithmetic, ~9 operations per (query,
// candidate) pair with nothing to reuse; at the serving shape (B=256
// clouds, N=512, k=20) 67.1 M pairs over 33.5 T lane-operations/s is
// ~18 us, and the 21 MB of int64 output ~7 us at 3.35 TB/s. The design:
// one thread per query point holds its point and a sorted list of the KB
// best (distance, index) pairs in registers (KB, a compile-time bucket
// >= k, keeps every list access at a static index); the block stages the
// cloud as float4 (-2x, -2y, -2z, |q|^2) tiles in shared memory, where
// every read is a broadcast. Candidates are swept in ascending index order
// and enter the list only on a strict <, behind every equal entry. The
// list insertion is warp-divergent, so a sweep costs several times the
// ALU bound; a warp-cooperative selection is later work.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // candidates staged per pass: 16 KB

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
knn_points_kernel(const float* __restrict__ pts, int n, int k,
                  long long* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float* cloud = pts + (size_t)b * n * 3;
  const float* a = cloud + (size_t)(active ? i : 0) * 3;
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const float sa = sq_norm(a0, a1, a2);

  float dist[KB];
  int idx[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    dist[s] = CUDART_INF_F;
    idx[s] = 0;
  }

  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int cnt = min(kTile, n - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float* q = cloud + (size_t)(j0 + t) * 3;
      const float x = q[0], y = q[1], z = q[2];
      tile[t] = make_float4(-2.f * x, -2.f * y, -2.f * z, sq_norm(x, y, z));
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      const float4 q = tile[t];
      const float cross2 = __fadd_rn(
          __fadd_rn(__fmul_rn(a0, q.x), __fmul_rn(a1, q.y)),
          __fmul_rn(a2, q.z));
      const float d2 = __fadd_rn(__fadd_rn(sa, cross2), q.w);
      if (d2 < dist[KB - 1]) {
        // insert behind every entry <= d2, shifting the rest down by one;
        // from the end, so each slot still reads its old neighbour
        const int j = j0 + t;
#pragma unroll
        for (int s = KB - 1; s > 0; --s) {
          if (d2 < dist[s - 1]) {
            dist[s] = dist[s - 1];
            idx[s] = idx[s - 1];
          } else if (d2 < dist[s]) {
            dist[s] = d2;
            idx[s] = j;
          }
        }
        if (d2 < dist[0]) {
          dist[0] = d2;
          idx[0] = j;
        }
      }
    }
  }
  if (active) {
    long long* o = out + ((size_t)b * n + i) * k;
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s < k) o[s] = idx[s];
    }
  }
}

template <int KB>
cudaError_t launch(const float* pts, int batch, int n, int k, long long* out,
                   cudaStream_t stream) {
  dim3 grid((n + kThreads - 1) / kThreads, batch);
  knn_points_kernel<KB><<<grid, kThreads, 0, stream>>>(pts, n, k, out);
  return cudaGetLastError();
}

}  // namespace

// pts: (batch, n, 3) f32 on the device; out: (batch, n, k) int64, with
// 1 <= k <= min(n, 64). Returns the CUDA error code of the launch.
extern "C" int knn_points_launch(const float* pts, int batch, int n, int k,
                                 long long* out, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || k < 1 || k > n || k > 64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return (int)launch<8>(pts, batch, n, k, out, s);
  if (k <= 20) return (int)launch<20>(pts, batch, n, k, out, s);
  if (k <= 32) return (int)launch<32>(pts, batch, n, k, out, s);
  return (int)launch<64>(pts, batch, n, k, out, s);
}
