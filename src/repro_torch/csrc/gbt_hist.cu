// Gradient histograms of the histogram GBT, for every node of one tree level
// in one launch: per (node, feature, bin) the gradient sum and row count,
// exactly as the reference adds them.
//
// Replaces: src/repro/kernels/gbt_hist/kernel.py, grad_histogram_kernel
// (the Pallas TPU kernel, body _kernel), which builds one node's histogram
// from a [rows, F, bins] one-hot mask per row block reduced on the VPU,
// because a TPU has no scatter-add.
//
// The function: the level's rows are given grouped by node, order[M] (node
// k's rows are order[offsets[k] .. offsets[k+1]), ascending, as the
// reference's idx[mask] / idx[~mask] keep them).  gsum[k, f, b] is the f64
// sum of grad[r] over node k's rows r with codes[r, f] == b, added in
// ascending r starting from +0.0 with no FMA, and cnt[k, f, b] the number
// of those rows.  That is np.bincount's order (it adds each weight into its
// bin, row by row), which the reference's GBT fit uses for each node
// (src/repro/core/predictors/gbt.py, grad_histogram), so the card's
// histograms equal the reference's bit for bit and a fit on the card grows
// the reference's trees.  Codes outside [0, n_bins) are not counted.
// Nothing is added with atomics, so every run gives the same bits.
//
// What bounds it on the H100: bytes, in principle: each row of the level is
// read once (F int32 codes, one f64 gradient, its int32 id) for one add to a
// sum and one to a count per (row, feature).  At the GBT's sizes (a level
// holds at most the tree's ~12.6k rows, F = 7, 64 bins) it moves well under
// 1 MB; what sets a level's time is its largest node: the dependent chain of
// f64 adds of one bin, which the order above makes sequential.
//
// Design: one warp per (node, feature, group of 32 bins), a lane per bin,
// WARPS warps a block, so a level of K nodes is K * F * ceil(n_bins / 32)
// warps in one launch: at the root of chip_smoke's fit 14 warps walk 12,589
// rows each; at its widest level (130 nodes, 8,376 rows) 1,820 warps walk
// 4 to 432 rows each, 38 at the median.  A warp stages BATCH of its
// node's rows (the row id, the code of its feature, the gradient) in shared
// memory, the next batch already loading into registers while it walks this
// one; every lane walks the batch in row order and adds the gradients whose
// code is its bin.  The walk is branch-free over the rows (a predicated
// add), so the loads run ahead and only the adds form the chain, whose
// length is the node's row count.  Padding rows carry code -1: no bin.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                // (node, feature, bin group)s a block
constexpr int THREADS = 32 * WARPS;
constexpr int PER_LANE = 4;             // rows each lane stages
constexpr int BATCH = 32 * PER_LANE;    // rows a warp stages at a time
constexpr int UNROLL = 8;               // rows walked per step
static_assert(BATCH % UNROLL == 0, "a batch holds whole steps");

__global__ void __launch_bounds__(THREADS)
    gbt_level_hist(const int32_t* __restrict__ codes,
                   const double* __restrict__ grad,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ offsets, int n_nodes,
                   int n_feat, int n_bins, double* __restrict__ gsum,
                   int32_t* __restrict__ cnt) {
  __shared__ int32_t s_code[WARPS][BATCH];
  __shared__ double s_grad[WARPS][BATCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (n_bins + 31) / 32;
  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= (long long)n_nodes * n_feat * groups) return;  // whole warp
  const int g = (int)(item % groups);
  const int f = (int)(item / groups % n_feat);
  const int k = (int)(item / groups / n_feat);
  const int bin = g * 32 + lane;
  const int lo = __ldg(offsets + k), hi = __ldg(offsets + k + 1);
  int32_t* sc = s_code[warp];
  double* sg = s_grad[warp];

  // this lane's rows of the batch at i0 (code -1 past the node's last row)
  int32_t rc[PER_LANE];
  double rg[PER_LANE];
  auto fetch = [&](int i0) {
    int32_t r[PER_LANE];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int i = i0 + 32 * u + lane;
      r[u] = i < hi ? __ldg(order + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      rc[u] = r[u] >= 0 ? __ldg(codes + (long long)r[u] * n_feat + f) : -1;
      rg[u] = r[u] >= 0 ? __ldg(grad + r[u]) : 0.0;
    }
  };

  double s = 0.0;
  int c = 0;
  if (lo < hi) fetch(lo);
  for (int i0 = lo; i0 < hi; i0 += BATCH) {
    __syncwarp();  // the walk of the previous batch is done
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      sc[32 * u + lane] = rc[u];
      sg[32 * u + lane] = rg[u];
    }
    __syncwarp();
    if (i0 + BATCH < hi) fetch(i0 + BATCH);  // in flight during the walk
    const int len = hi - i0 < BATCH ? hi - i0 : BATCH;
    for (int j = 0; j < len; j += UNROLL) {  // rows past len hold code -1
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (sc[j + u] == bin) {
          s = __dadd_rn(s, sg[j + u]);
          ++c;
        }
      }
    }
  }
  if (bin < n_bins) {
    const size_t at = ((size_t)k * n_feat + f) * n_bins + bin;
    gsum[at] = s;
    cnt[at] = c;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// codes [n_rows, n_feat] int32, grad [n_rows] f64, order [M] int32 (row ids
// grouped by node, each in [0, n_rows)), offsets [n_nodes + 1] int32
// (non-decreasing, from 0 to M) -> gsum [n_nodes, n_feat, n_bins] f64, cnt
// [n_nodes, n_feat, n_bins] int32, every entry written.  n_nodes >= 1,
// n_feat >= 1, n_bins >= 1.  Returns cudaGetLastError() after the launch.
int gbt_hist(const void* codes, const void* grad, const void* order,
             const void* offsets, int n_nodes, int n_feat, int n_bins,
             void* gsum, void* cnt, void* stream) {
  if (n_nodes < 1 || n_feat < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  const long long items =
      (long long)n_nodes * n_feat * ((n_bins + 31) / 32);
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gbt_level_hist<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const double*>(grad),
      static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(offsets), n_nodes, n_feat, n_bins,
      static_cast<double*>(gsum), static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
