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
// What bounds it on the H100: instruction issue. Every (source, destination)
// pair costs 7 FP32 operations for the distance plus a compare and two
// selects for the running argmin, with nothing to reuse across pairs; the
// card issues one warp instruction per clock on each of its 528 schedulers.
// The design spends as little as it can beside those ten:
//
// - Column table, built once per call by a pre-pass kernel: per
//   destination point (-2x, -2y, -2z, |q|^2 or +inf) as a float4, padded
//   with (0, 0, 0, +inf) to a multiple of kGroup columns, and per pair the
//   number of columns to sweep (1 + the last valid index, 0 for none).
//   Sweep blocks no longer re-derive the table, and a pair's trailing
//   padding (clouds padded to the largest of the batch) is never swept.
// - Register blocking: a thread holds kRows source points; one broadcast
//   shared-memory read of a column feeds kRows distance evaluations, and
//   the kRows running minima are independent chains. The index is 32-bit
//   until the store.
// - The clamp leaves the inner loop: the sweep keeps the strict-less
//   minimum of the unclamped value t. Where it ends above 0, that is the
//   clamped answer; where it ends at or below 0 (a source point on top of a
//   destination point, rare) the clamped minimum is 0 and its first index
//   is the first column with t <= 0, which a short second sweep of that
//   row finds.
// - Double-buffered staging: tiles of kTile columns stream into shared
//   memory with cp.async while the previous tile is swept.
// - Occupancy: the columns of a row strip may be split into chunks swept
//   by separate blocks. Each writes its chunk's (d2, index); a merge pass
//   takes the smaller d2 and, on equal d2, the earlier chunk, which is the
//   answer of one ascending strict-less sweep. The wrapper's chunk
//   (ops/nn_kernels.py: CHUNK, 512 columns) fills the card at the ICP
//   shape and leaves the flip shape (512 columns) unsplit.
// - Non-finite distances stay out of the hot loop. The plain version's
//   clamp passes a NaN and its argmin returns the first NaN, masked
//   columns included; the strict-less sweep never takes a NaN. A NaN or
//   an infinite sum can only come from a source or destination point with
//   |p|^2 >= 2^63 (a NaN or infinite coordinate, or one near the float
//   range): below that every distance is finite, and a masked column's is
//   +inf. The pre-pass flags each pair holding such a destination point,
//   masked or not; a source row is flagged by its own |a|^2. A flagged row
//   is settled after the sweep by the plain version's own rule over all
//   columns (in the chunk-0 block, whose answer the merge then takes as
//   it is). Finite data never flags a row.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kTile = 256;        // columns per staged tile (4 KB)
constexpr int kGroup = 8;         // columns per unrolled step
constexpr int kRows = 4;          // source points a sweep thread holds
constexpr int kMaxThreads = 128;  // threads of a sweep block
constexpr int kTableThreads = 1024;  // one table block a pair
constexpr float kSafe = 9.223372036854775808e18f;  // 2^63: see above

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (|a|^2 + ((a0 q0' + a1 q1') + a2 q2')) + |q|^2, unclamped
__device__ __forceinline__ float dist(float a0, float a1, float a2, float sa,
                                     float4 q) {
  const float cross2 = __fadd_rn(
      __fadd_rn(__fmul_rn(a0, q.x), __fmul_rn(a1, q.y)), __fmul_rn(a2, q.z));
  return __fadd_rn(__fadd_rn(sa, cross2), q.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void stage(float4* dst, const float4* src, int n) {
  for (int x = threadIdx.x; x < n; x += blockDim.x) cp_async16(dst + x, src + x);
}

// grid (batch): one block a pair writes its column table, the pair's
// column count, 1 + the last valid column (0 for none), into cols[b], and
// into cols[batch + b] whether a destination point has |q|^2 >= 2^63
__global__ void nn_table_kernel(const float* __restrict__ dst,
                                const unsigned char* __restrict__ mask, int n2,
                                int n2p, float4* __restrict__ table,
                                int* __restrict__ cols) {
  __shared__ int warp_last[kTableThreads / 32];
  __shared__ int warp_flag[kTableThreads / 32];
  const int b = blockIdx.x;
  int last = 0, flag = 0;
  for (int j = threadIdx.x; j < n2p; j += kTableThreads) {
    float4 row = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    if (j < n2) {
      const float* q = dst + ((size_t)b * n2 + j) * 3;
      const float x = q[0], y = q[1], z = q[2];
      row = make_float4(-2.f * x, -2.f * y, -2.f * z, CUDART_INF_F);
      const float sq = sq_norm(x, y, z);
      flag |= !(sq < kSafe);  // NaN too
      if (mask[(size_t)b * n2 + j]) {
        row.w = sq;
        last = j + 1;
      }
    }
    table[(size_t)b * n2p + j] = row;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    flag |= __shfl_xor_sync(0xffffffffu, flag, o);
  }
  if (threadIdx.x % 32 == 0) {
    warp_last[threadIdx.x / 32] = last;
    warp_flag[threadIdx.x / 32] = flag;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kTableThreads / 32; ++w) {
      last = max(last, warp_last[w]);
      flag |= warp_flag[w];
    }
    cols[b] = last;
    cols[gridDim.x + b] = flag;
  }
}

int table_launch(const float* dst, const unsigned char* mask, int batch,
                 int n2, int n2p, float4* table, int* cols, cudaStream_t s) {
  nn_table_kernel<<<batch, kTableThreads, 0, s>>>(dst, mask, n2, n2p, table,
                                                  cols);
  return (int)cudaGetLastError();
}

// A source row is settled by the exact rule when it or its pair is flagged
__device__ __forceinline__ bool flagged(const int* cols, int batch, int b,
                                        float sa) {
  return cols[batch + b] != 0 || !(sa < kSafe);
}

// The plain version's answer for one source row over the columns [0, n2)
// of its pair: d2 = clamp(dist, 0) with a NaN passed through, then the
// first NaN or else the first minimum (torch.argmin)
__device__ void exact_row(const float4* tb, int n2, float a0, float a1,
                          float a2, float sa, float& best, int& bi) {
  best = CUDART_INF_F;
  bi = 0;
  for (int j = 0; j < n2; ++j) {
    const float d = dist(a0, a1, a2, sa, tb[j]);
    if (d != d) {
      best = d;
      bi = j;
      return;
    }
    const float c = fmaxf(d, 0.f);
    if (c < best) {
      best = c;
      bi = j;
    }
  }
}

// grid (row strips, column chunks, batch); thread x of strip s holds rows
// s * kRows * blockDim.x + x + r * blockDim.x, r < kRows
__global__ void __launch_bounds__(kMaxThreads)
nn_sweep_kernel(const float4* __restrict__ table, const int* __restrict__ cols,
                const float* __restrict__ src, int batch, int n1, int n2,
                int n2p, int chunk,
                float* __restrict__ part_d2, int* __restrict__ part_idx,
                long long* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const int b = blockIdx.z;
  const int split = blockIdx.y, splits = gridDim.y;
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, (cols[b] + kGroup - 1) / kGroup * kGroup);
  // the merge reads only the chunks that start below the column count,
  // and chunk 0 for a flagged row
  if (splits > 1 && c0 >= c1 && split > 0) return;

  const int row0 = blockIdx.x * kRows * blockDim.x + threadIdx.x;
  float a0[kRows], a1[kRows], a2[kRows], sa[kRows], best[kRows];
  int bi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(row0 + r * (int)blockDim.x, n1 - 1);
    const float* a = src + ((size_t)b * n1 + i) * 3;
    a0[r] = a[0];
    a1[r] = a[1];
    a2[r] = a[2];
    sa[r] = sq_norm(a0[r], a1[r], a2[r]);
    best[r] = CUDART_INF_F;
    bi[r] = 0;
  }

  const float4* tb = table + (size_t)b * n2p;
  const int ntiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
  if (ntiles > 0) stage(tile[0], tb + c0, min(kTile, c1 - c0));
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int s0 = c0 + t * kTile;
    const int n = min(kTile, c1 - s0);  // a multiple of kGroup
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < ntiles) {
      stage(tile[(t + 1) & 1], tb + s0 + kTile, min(kTile, c1 - s0 - kTile));
    }
    cp_async_commit();
    const float4* q = tile[t & 1];
    for (int g = 0; g < n; g += kGroup) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 v = q[g + u];
        const int j = s0 + g + u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d = dist(a0[r], a1[r], a2[r], sa[r], v);
          if (d < best[r]) {
            best[r] = d;
            bi[r] = j;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (flagged(cols, batch, b, sa[r])) {  // only chunk 0's answer is read
      if (split == 0) exact_row(tb, n2, a0[r], a1[r], a2[r], sa[r], best[r],
                                bi[r]);
    } else if (best[r] <= 0.f) {  // the clamped minimum is 0: its first column
      for (int j = c0; j < c1; ++j) {
        if (dist(a0[r], a1[r], a2[r], sa[r], tb[j]) <= 0.f) {
          bi[r] = j;
          break;
        }
      }
      best[r] = 0.f;
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r * (int)blockDim.x;
    if (i >= n1) continue;
    if (splits == 1) {
      out_idx[(size_t)b * n1 + i] = bi[r];
      out_d2[(size_t)b * n1 + i] = best[r];
    } else {
      const size_t o = ((size_t)b * splits + split) * n1 + i;
      part_d2[o] = best[r];
      part_idx[o] = bi[r];
    }
  }
}

// grid (row blocks, batch): the chunks' answers in ascending column order,
// strict-less, as one sweep would take them; chunk 0's for a flagged row
__global__ void nn_merge_kernel(const float* __restrict__ part_d2,
                                const int* __restrict__ part_idx,
                                const int* __restrict__ cols,
                                const float* __restrict__ src, int batch,
                                int n1, int chunk, int splits,
                                long long* __restrict__ out_idx,
                                float* __restrict__ out_d2) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1) return;
  const float* a = src + ((size_t)b * n1 + i) * 3;
  if (flagged(cols, batch, b, sq_norm(a[0], a[1], a[2]))) {
    const size_t o = (size_t)b * splits * n1 + i;
    out_idx[(size_t)b * n1 + i] = part_idx[o];
    out_d2[(size_t)b * n1 + i] = part_d2[o];
    return;
  }
  const int used = (cols[b] + chunk - 1) / chunk;
  float best = CUDART_INF_F;
  int bi = 0;
  for (int s = 0; s < used; ++s) {
    const size_t o = ((size_t)b * splits + s) * n1 + i;
    const float d = part_d2[o];
    if (d < best) {
      best = d;
      bi = part_idx[o];
    }
  }
  out_idx[(size_t)b * n1 + i] = bi;
  out_d2[(size_t)b * n1 + i] = best;
}

bool shapes_ok(int batch, int n2, int n2p) {
  return batch >= 1 && batch <= 65535 && n2 >= 1 && n2p >= n2 &&
         n2p % kGroup == 0 && n2p - n2 < kGroup;
}

}  // namespace

// dst: (batch, n2, 3) f32, mask: (batch, n2) bytes (non-zero = valid);
// table: (batch, n2p, 4) f32 with n2p = n2 rounded up to a multiple of 8;
// cols: (2, batch) int32. All on the device. Writes the column table, the
// per-pair column counts (cols[0]) and flags (cols[1]: a destination point
// with |q|^2 >= 2^63 or not finite); returns the CUDA error code.
extern "C" int nn_table_launch(const float* dst, const unsigned char* mask,
                               int batch, int n2, int n2p, void* table,
                               int* cols, void* stream) {
  if (!shapes_ok(batch, n2, n2p)) return (int)cudaErrorInvalidValue;
  return table_launch(dst, mask, batch, n2, n2p, static_cast<float4*>(table),
                      cols, static_cast<cudaStream_t>(stream));
}

// src: (batch, n1, 3) f32; dst, mask, table, cols as for nn_table_launch
// (table and cols are written here); chunk: columns per sweep block, a
// multiple of 8; part_d2 / part_idx: (batch, ceil(n2p / chunk), n1) f32 /
// int32 scratch, unused (may be null) when one chunk covers n2p; out_idx:
// (batch, n1) int64, out_d2: (batch, n1) f32. All on the device. Returns
// the CUDA error code of the launches.
extern "C" int nn_argmin_launch(const float* src, const float* dst,
                                const unsigned char* mask, int batch, int n1,
                                int n2, int n2p, int chunk, void* table,
                                int* cols, float* part_d2, int* part_idx,
                                long long* out_idx, float* out_d2,
                                void* stream) {
  if (!shapes_ok(batch, n2, n2p) || n1 < 1 || chunk < kGroup ||
      chunk % kGroup != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int splits = (n2p + chunk - 1) / chunk;
  if (splits > 65535 || (splits > 1 && (!part_d2 || !part_idx))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* t = static_cast<float4*>(table);
  int err = table_launch(dst, mask, batch, n2, n2p, t, cols, s);
  if (err != 0) return err;
  int threads = (n1 + kRows - 1) / kRows;
  threads = min(kMaxThreads, (threads + 31) / 32 * 32);
  const int strips = (n1 + kRows * threads - 1) / (kRows * threads);
  nn_sweep_kernel<<<dim3(strips, splits, batch), threads, 0, s>>>(
      t, cols, src, batch, n1, n2, n2p, chunk, part_d2, part_idx, out_idx,
      out_d2);
  err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  nn_merge_kernel<<<dim3((n1 + 255) / 256, batch), 256, 0, s>>>(
      part_d2, part_idx, cols, src, batch, n1, chunk, splits, out_idx,
      out_d2);
  return (int)cudaGetLastError();
}
