// Gradient histogram of the histogram GBT: per (feature, bin) gradient sum
// and row count.
//
// Replaces: src/repro/kernels/gbt_hist/kernel.py, grad_histogram_kernel
// (the Pallas TPU kernel, body _kernel), which builds a [rows, F, bins]
// one-hot mask per row block and reduces it on the VPU, because a TPU has
// no scatter-add.
//
// What bounds it on the H100: bytes.  Each row is read once (F int32 codes
// + one f32 gradient) and the work is two adds per (row, feature), far
// below the card's operations-per-byte line.  At the GBT's per-node sizes
// (N up to ~16k rows, F = 7, 64 bins) the kernel moves well under 1 MB and
// is bound by its launch, not by either rate.
//
// Design: the scatter-add histogram the TPU could not do.  Each block keeps
// a private [F, n_bins] histogram in shared memory (f32 sums and int32
// counts; 3.5 KB at F = 7, 64 bins), walks (row, feature) pairs with a
// grid-stride loop so neighbouring threads read neighbouring codes, and
// adds into shared memory with atomics; then it adds its non-empty bins
// into the global output with one atomic each.  Few blocks (the grid is
// capped) keep the global atomics few.  Counts are exact; the f32 sums
// depend on the order of the atomics, which varies from run to run.
// Codes outside [0, n_bins) are skipped (the TPU one-hot ignores them too).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gbt_hist_kernel(const int32_t* __restrict__ codes,
                                const float* __restrict__ grad,
                                long long n_rows, int n_feat, int n_bins,
                                float* __restrict__ gsum,
                                int32_t* __restrict__ cnt) {
  extern __shared__ unsigned char smem[];
  const int fb = n_feat * n_bins;
  float* s_sum = reinterpret_cast<float*>(smem);
  int* s_cnt = reinterpret_cast<int*>(s_sum + fb);
  for (int i = threadIdx.x; i < fb; i += blockDim.x) {
    s_sum[i] = 0.0f;
    s_cnt[i] = 0;
  }
  __syncthreads();
  const long long total = n_rows * n_feat;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    const long long row = k / n_feat;
    const int feat = (int)(k - row * n_feat);
    const int code = codes[k];
    if (code >= 0 && code < n_bins) {
      atomicAdd(&s_sum[feat * n_bins + code], __ldg(grad + row));
      atomicAdd(&s_cnt[feat * n_bins + code], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < fb; i += blockDim.x) {
    if (s_cnt[i] != 0) {
      atomicAdd(&gsum[i], s_sum[i]);
      atomicAdd(&cnt[i], s_cnt[i]);
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// codes [n_rows, n_feat] int32, grad [n_rows] f32 -> gsum, cnt
// [n_feat, n_bins] (f32, int32), zeroed here first.  Returns
// cudaGetLastError() after the launch.
int gbt_hist(const void* codes, const void* grad, long long n_rows,
             int n_feat, int n_bins, void* gsum, void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (size_t)n_feat * n_bins * 4;
  cudaMemsetAsync(gsum, 0, out_bytes, s);
  cudaMemsetAsync(cnt, 0, out_bytes, s);
  const int threads = 256;
  const long long work = n_rows * n_feat;
  long long blocks = (work + threads * 8 - 1) / (threads * 8);
  if (blocks < 1) blocks = 1;
  if (blocks > 264) blocks = 264;  // two blocks per SM: few global atomics
  const size_t smem = (size_t)n_feat * n_bins * 8;
  gbt_hist_kernel<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const int32_t*>(codes), static_cast<const float*>(grad),
      n_rows, n_feat, n_bins, static_cast<float*>(gsum),
      static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
