// Exact k-nearest neighbours within each point cloud, for sm_90a.
//
// Replaces the TPU kernel alignnet3d_tpu/ops/knn_kernels.py
// (knn_points_pallas / _knn_kernel), the graph build of the DGCNN
// backbone. For every point a of cloud b it writes the indices of the k
// points q of the same cloud with the smallest
//
//     d2(a, q) = (|a|^2 - 2 a.q) + |q|^2,
//
// in the order of the Pallas kernel's argmin rounds: every NaN distance
// first, then ascending d2, ties to the lower index. The cross term is
// summed as ((a0 q0' + a1 q1') + a2 q2') with q' = -2 q, which is -2 a.q
// exactly, and every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn: no contraction into FMAs), in the order the plain PyTorch
// version knn_points_plain evaluates them, so the two agree bit for bit.
//
// What bounds it on Hopper: FP32 arithmetic, ~9 operations per (query,
// candidate) pair with nothing to reuse; at the serving shape (B=256
// clouds, N=512, k=20) 67.1 M pairs over 33.5 T lane-operations/s is
// ~18 us, and the 21 MB of int64 output ~7 us at 3.35 TB/s.
//
// The design: one thread per query point; the block stages the cloud as
// float4 (-2x, -2y, -2z, |q|^2) tiles in shared memory, where every read is
// a broadcast. Each distance becomes a uint32 key, monotone in d2 with
// every NaN at 0, and each thread keeps its KB best keys and indices in a
// sorted register list (KB, a compile-time bucket >= k, keeps every list
// access at a static index). The selection never branches per lane: a
// candidate whose key beats the list's last entry is appended to the
// thread's queue in shared memory by a predicated store; every kStep
// candidates the warp votes, and when some lane's queue is nearly full the
// whole warp merges its queues into its lists, entry by entry, with a
// branch-free insertion of select instructions (skipped, by another vote,
// for an entry that no lane still needs). Candidates arrive in ascending
// index order and enter a list only on a strict <, behind every equal key,
// so ties go to the lower index.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;   // candidates staged per pass: 16 KB
constexpr int kQueue = 16;    // queued candidates per thread: 16 KB a block
constexpr int kStep = 4;      // candidates between two votes
constexpr unsigned kEmpty = 0xffffffffu;  // above the key of every distance
constexpr unsigned kFull = 0xffffffffu;   // all lanes of a warp

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Monotone in d: -inf < ... < +inf map to 0x007fffff ... 0xff800000, and
// every NaN to 0, first. d2 = x + |q|^2 with |q|^2 >= +0 is never -0.0, so
// +0.0 alone stands for zero (order_key of ops/knn_kernels.py gives -0.0
// and +0.0 one key, which ranks the same).
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned b = __float_as_uint(d);
  const unsigned key = b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
  return isnan(d) ? 0u : key;
}

// Inserts (x, j) into the ascending list behind every key <= x, dropping
// the last entry; a no-op for x == kEmpty. Select instructions only.
template <int KB>
__device__ __forceinline__ void insert(unsigned (&key)[KB], int (&id)[KB],
                                       unsigned x, int j) {
#pragma unroll
  for (int s = KB - 1; s > 0; --s) {
    const bool before_prev = x < key[s - 1];
    const bool before = x < key[s];
    key[s] = before_prev ? key[s - 1] : (before ? x : key[s]);
    id[s] = before_prev ? id[s - 1] : (before ? j : id[s]);
  }
  if (x < key[0]) {
    key[0] = x;
    id[0] = j;
  }
}

// Merges every lane's queue into its list, in queue (= index) order.
// Called by all 32 lanes of the warp together.
template <int KB>
__device__ __forceinline__ void merge(unsigned (&key)[KB], int (&id)[KB],
                                      const uint2 (*queue)[kThreads],
                                      int& cnt) {
  for (int s = 0; s < kQueue; ++s) {
    if (!__any_sync(kFull, s < cnt)) break;
    const uint2 e = queue[s][threadIdx.x];
    const unsigned x = s < cnt ? e.x : kEmpty;
    if (__any_sync(kFull, x < key[KB - 1])) insert(key, id, x, (int)e.y);
  }
  cnt = 0;
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
knn_points_kernel(const float* __restrict__ pts, int n, int k,
                  long long* __restrict__ out) {
  __shared__ float4 tile[kTile];
  __shared__ uint2 queue[kQueue][kThreads];  // (key, index) per thread
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;  // the others sweep too: the votes need them
  const float* cloud = pts + (size_t)b * n * 3;
  const float* a = cloud + (size_t)(active ? i : 0) * 3;
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const float sa = sq_norm(a0, a1, a2);

  unsigned key[KB];
  int id[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    key[s] = kEmpty;
    id[s] = 0;
  }
  int cnt = 0;  // this thread's queued candidates

  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int cnt_tile = min(kTile, n - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt_tile; t += kThreads) {
      const float* q = cloud + (size_t)(j0 + t) * 3;
      const float x = q[0], y = q[1], z = q[2];
      tile[t] = make_float4(-2.f * x, -2.f * y, -2.f * z, sq_norm(x, y, z));
    }
    __syncthreads();
    for (int t0 = 0; t0 < cnt_tile; t0 += kStep) {
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int t = t0 + u;  // < kTile: cnt_tile <= kTile, both % kStep
        const float4 q = tile[t];
        const float cross2 = __fadd_rn(
            __fadd_rn(__fmul_rn(a0, q.x), __fmul_rn(a1, q.y)),
            __fmul_rn(a2, q.z));
        const unsigned x =
            order_key(__fadd_rn(__fadd_rn(sa, cross2), q.w));
        if (t < cnt_tile && x < key[KB - 1]) {  // predicated, not a branch
          queue[cnt][threadIdx.x] = make_uint2(x, (unsigned)(j0 + t));
          ++cnt;
        }
      }
      if (__any_sync(kFull, cnt > kQueue - kStep)) merge(key, id, queue, cnt);
    }
  }
  merge(key, id, queue, cnt);
  if (active) {
    long long* o = out + ((size_t)b * n + i) * k;
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s < k) o[s] = id[s];
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
