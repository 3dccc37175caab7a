// Gradient histogram of the histogram GBT: per (feature, bin) gradient sum
// and row count, exactly as the reference adds them.
//
// Replaces: src/repro/kernels/gbt_hist/kernel.py, grad_histogram_kernel
// (the Pallas TPU kernel, body _kernel), which builds a [rows, F, bins]
// one-hot mask per row block and reduces it on the VPU, because a TPU has
// no scatter-add.
//
// The function: gsum[f, b] is the f64 sum of grad[r] over the rows r with
// codes[r, f] == b, added in increasing r starting from +0.0 with no FMA,
// and cnt[f, b] the number of those rows.  That is np.bincount's order (it
// adds each weight into its bin, row by row), which the reference's GBT
// fit uses (src/repro/core/predictors/gbt.py, grad_histogram), so the
// card's histograms equal the reference's bit for bit and a fit on the
// card grows the reference's trees.  Codes outside [0, n_bins) are not
// counted.  Nothing is added with atomics, so every run gives the same bits.
//
// What bounds it on the H100: bytes, in principle: each row is read once
// (F int32 codes + one f64 gradient) for one add to a sum and one to a
// count per (row, feature).  At the GBT's per-node sizes (N up to ~16k
// rows, F = 7, 64 bins) it moves well under 1 MB, and what sets its time is
// the chain of dependent f64 adds of one bin, which the order above makes
// sequential.
//
// Design: one warp per (feature, bin), BINS warps a block, so the chain of
// a bin holds only that bin's rows (~N / n_bins adds), not all N, and the
// F * n_bins chains run on many SMs at once.  A block stages CHUNK rows of
// its feature's codes and the gradients in shared memory (the next chunk is
// read into registers while the warps walk this one); a warp walks the
// chunk 32 rows at a time: each lane compares one row's code with the
// warp's bin, a ballot gives the hits in row order, the count adds their
// number, and the sum adds their gradients lowest row first: one by one
// where a group of 32 rows holds few hits, and where it holds DENSE or
// more, branch-free over all 32 rows (s += hit ? g : 0.0), so that the
// gradients' loads run ahead and only the adds form the chain (a feature
// with few distinct values puts most of a node's rows in one bin, and that
// bin's chain then sets the time).  GROUPS ballots are taken before their
// hits are added, so their loads overlap.
// Skipping a row that misses is the same as adding +0.0 to it: the running
// sum starts at +0.0 and a sum of non-zero terms and +0.0 is never -0.0, so
// s + 0.0 == s bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BINS = 8;                 // bins (warps) per block
constexpr int THREADS = 32 * BINS;
constexpr int PER_THREAD = 8;           // rows each thread stages
constexpr int CHUNK = THREADS * PER_THREAD;  // rows staged at a time
constexpr int GROUPS = 8;               // 32-row ballots a warp takes at once
constexpr int DENSE = 4;                // hits in 32 rows that take the
                                        // branch-free walk
static_assert(CHUNK % (32 * GROUPS) == 0, "a chunk holds whole groups");

__global__ void __launch_bounds__(THREADS)
    gbt_hist_kernel(const int32_t* __restrict__ codes,
                    const double* __restrict__ grad, long long n_rows,
                    int n_feat, int n_bins, double* __restrict__ gsum,
                    int32_t* __restrict__ cnt) {
  __shared__ int32_t s_code[CHUNK];
  __shared__ double s_grad[CHUNK];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, bin = blockIdx.y * BINS + tid / 32;

  // this thread's rows of the chunk at r0 (code -1 past the last row:
  // it matches no bin)
  int32_t rc[PER_THREAD];
  double rg[PER_THREAD];
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const long long r = r0 + j * THREADS + tid;
      rc[j] = r < n_rows ? __ldg(codes + r * n_feat + f) : -1;
      rg[j] = r < n_rows ? __ldg(grad + r) : 0.0;
    }
  };

  double s = 0.0;
  int c = 0;
  fetch(0);
  for (long long r0 = 0; r0 < n_rows; r0 += CHUNK) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      s_code[j * THREADS + tid] = rc[j];
      s_grad[j * THREADS + tid] = rg[j];
    }
    __syncthreads();
    if (r0 + CHUNK < n_rows) fetch(r0 + CHUNK);  // in flight during the walk
    if (bin < n_bins) {
      const int len = (int)(n_rows - r0 < CHUNK ? n_rows - r0 : CHUNK);
      for (int i = 0; i < len; i += 32 * GROUPS) {
        // the ballots of GROUPS x 32 rows first (independent loads), then
        // their hits in row order
        unsigned hits[GROUPS];
#pragma unroll
        for (int u = 0; u < GROUPS; ++u)
          hits[u] = __ballot_sync(0xffffffffu,
                                  s_code[i + 32 * u + lane] == bin);
#pragma unroll
        for (int u = 0; u < GROUPS; ++u) {
          unsigned h = hits[u];
          const int n_hit = __popc(h);
          const double* gr = s_grad + i + 32 * u;
          c += n_hit;
          if (n_hit >= DENSE) {
            // every row of the group in order, a miss adding +0.0: the
            // loads are independent, so only the adds form the chain
#pragma unroll
            for (int k = 0; k < 32; ++k)
              s = __dadd_rn(s, (h >> k) & 1u ? gr[k] : 0.0);
          } else {
            while (h) {                  // lowest row first
              const int r = __ffs(h) - 1;
              h &= h - 1;
              s = __dadd_rn(s, gr[r]);
            }
          }
        }
      }
    }
    __syncthreads();  // the walk is done before the next chunk is stored
  }
  if (bin < n_bins && lane == 0) {
    gsum[(size_t)f * n_bins + bin] = s;
    cnt[(size_t)f * n_bins + bin] = c;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// codes [n_rows, n_feat] int32, grad [n_rows] f64 -> gsum [n_feat, n_bins]
// f64, cnt [n_feat, n_bins] int32, every entry written.  n_rows >= 0,
// n_feat >= 1, 1 <= n_bins <= 65535 * BINS.  Returns cudaGetLastError()
// after the launch.
int gbt_hist(const void* codes, const void* grad, long long n_rows,
             int n_feat, int n_bins, void* gsum, void* cnt, void* stream) {
  if (n_rows < 0 || n_feat < 1 || n_bins < 1 ||
      (n_bins + BINS - 1) / BINS > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_feat, (n_bins + BINS - 1) / BINS);
  gbt_hist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const double*>(grad),
      n_rows, n_feat, n_bins, static_cast<double*>(gsum),
      static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
