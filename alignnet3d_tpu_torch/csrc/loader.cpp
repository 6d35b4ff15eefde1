// Batch assembler for the packed point-cloud dataset, host C++.
//
// The port's copy of native/loader.cpp, with the same ABI and the same
// draws: each of B samples resamples its cloud to num_points points with
// replacement and gathers them into a (B, num_points, 3) staging buffer in
// one pass, with a counter-based PRNG (splitmix64), no temporaries and no
// Python. A seed gives the same batch, bit for bit, in both packages.
//
// This is host code, not a kernel: it is built by g++ into its own shared
// library by alignnet3d_tpu_torch/data/native_loader.py (never by nvcc)
// and called through ctypes.

#include <cstdint>
#include <cstring>

namespace {

// splitmix64: a small counter-based PRNG with a full 64-bit mix.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// For each of B samples: draw num_points indices uniformly (with
// replacement) from [0, counts[row]) and gather xyz triples from
// points_flat starting at offsets[row] into out[b]. Empty clouds yield
// zeros (reference provider.py:95-96).
//
// points_flat: (total_points, 3) float32
// offsets/counts: per-row int64 (indexed by rows[b])
// rows: (B,) int64 packed-row numbers
// out: (B, num_points, 3) float32, caller-allocated
void resample_gather(const float* points_flat, const int64_t* offsets,
                     const int64_t* counts, const int64_t* rows,
                     int64_t batch, int64_t num_points, uint64_t seed,
                     float* out) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t row = rows[b];
    const int64_t count = counts[row];
    float* dst = out + b * num_points * 3;
    if (count <= 0) {
      std::memset(dst, 0, sizeof(float) * num_points * 3);
      continue;
    }
    const float* src = points_flat + offsets[row] * 3;
    // per-sample stream base, decorrelated by a full mix so that the
    // streams of neighbouring (b, row) pairs do not share counter ranges
    const uint64_t ctr = splitmix64(
        seed ^ splitmix64((static_cast<uint64_t>(row) << 32) ^
                          static_cast<uint64_t>(b) ^ 0xA5A5A5A5DEADBEEFULL));
    for (int64_t i = 0; i < num_points; ++i) {
      const uint64_t r = splitmix64(ctr + static_cast<uint64_t>(i));
      // 64-bit multiply-shift range reduction: the high word of r * count
      const uint64_t pick =
          static_cast<uint64_t>((static_cast<unsigned __int128>(r) *
                                 static_cast<unsigned __int128>(count)) >>
                                64);
      const float* p = src + pick * 3;
      dst[i * 3 + 0] = p[0];
      dst[i * 3 + 1] = p[1];
      dst[i * 3 + 2] = p[2];
    }
  }
}

// Gather label rows: out[b] = labels[rows[b]] for a (n_rows, dim) float64
// label matrix.
void gather_labels(const double* labels, const int64_t* rows, int64_t batch,
                   int64_t dim, double* out) {
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * dim, labels + rows[b] * dim,
                sizeof(double) * dim);
  }
}

int loader_abi_version() { return 1; }

}  // extern "C"
