// Fused offloading decision: the cost of every (environment, split) pair
// and a running first-index argmin per environment.
//
// Replaces: src/repro/kernels/decide_split/kernel.py, decide_split_kernel
// (the Pallas TPU kernel, body _kernel), which walks [block_e, block_s]
// tiles on a sequential grid and carries (min, argmin) in VMEM scratch.
//
// What bounds it on the H100: operations.  Per environment it reads 7 f32
// columns and writes a split and a cost (36 bytes: 38 MB at E = 2^20, about
// 11 us at 3.35 TB/s), but it evaluates about 30 f32 operations for every
// one of the L+1 splits (0.9 GFLOP at E = 2^20, L = 28: about 14 us at the
// 67 TFLOP/s of non-tensor f32), and four of them are IEEE divisions, which
// cost several instructions each.
//
// Design: one thread per environment, so the argmin needs no communication
// at all: the thread loops over every split and keeps (best, idx) in
// registers, replacing them only on a strict '<' so ties keep the first
// index (np.argmin semantics, as the Pallas kernel's strict '<' across
// split blocks).  The three [L+1] split rows are shared by every thread;
// they are staged through shared memory in chunks of CHUNK splits, so any
// L works, and every warp reads the same element at once (a broadcast).
// The [E, L+1] cost tensor never exists, in registers or in memory.  The
// 12 scalars of the lowered cost model (SPEC_* below, the layout of
// pack_spec in kernels/decide_split/kernel.py) come in as a small device
// array.  nvcc contracts f32 multiply-adds into FMAs here (-fmad=true is
// its default); the result is compared with the plain version within f32
// tolerance, and the chosen splits are re-costed exactly in f64 by the
// caller.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// spec vector layout: the cost model's scalar parameters
constexpr int SPEC_RADIO = 0, SPEC_PPS = 1, SPEC_PPG = 2, SPEC_DEADLINE = 3;
constexpr int SPEC_W0 = 4, SPEC_W1 = 5, SPEC_W2 = 6, SPEC_W3 = 7;
constexpr int SPEC_ETOT = 8, SPEC_WAIT = 9, SPEC_TEXC = 10, SPEC_W4 = 11;
constexpr int SPEC_LEN = 12;
constexpr int CHUNK = 128;    // splits staged in shared memory per pass
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
decide_split_kernel(const float* __restrict__ dcum,
                    const float* __restrict__ ecum,
                    const float* __restrict__ bvec,
                    const float* __restrict__ dev_div,
                    const float* __restrict__ edge_div,
                    const float* __restrict__ bw,
                    const float* __restrict__ lat,
                    const float* __restrict__ inp,
                    const float* __restrict__ dev_w,
                    const float* __restrict__ edge_w,
                    const float* __restrict__ spec, int n_envs,
                    int n_splits, int32_t* __restrict__ split_out,
                    float* __restrict__ cost_out) {
  __shared__ float s_d[CHUNK], s_e[CHUNK], s_b[CHUNK];
  __shared__ float s_spec[SPEC_LEN];
  if (threadIdx.x < SPEC_LEN) s_spec[threadIdx.x] = spec[threadIdx.x];

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < n_envs;
  float ddiv = 1.0f, ediv = 1.0f, bwc = 1.0f, latc = 0.0f, inpc = 0.0f;
  float dw = 0.0f, ew = 0.0f;
  if (live) {
    ddiv = dev_div[e];
    ediv = edge_div[e];
    bwc = fmaxf(bw[e], 1.0f);
    latc = lat[e];
    inpc = inp[e];
    dw = dev_w[e];
    ew = edge_w[e];
  }
  const int last = n_splits - 1;           // split == L: nothing offloaded
  float best = INFINITY;
  int idx = 0;

  for (int s0 = 0; s0 < n_splits; s0 += CHUNK) {
    const int len = min(CHUNK, n_splits - s0);
    __syncthreads();                       // previous chunk fully read
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_d[i] = dcum[s0 + i];
      s_e[i] = ecum[s0 + i];
      s_b[i] = bvec[s0 + i];
    }
    __syncthreads();
    if (!live) continue;
    const float radio = s_spec[SPEC_RADIO], pps = s_spec[SPEC_PPS];
    const float ppg = s_spec[SPEC_PPG], deadline = s_spec[SPEC_DEADLINE];
    const float w0 = s_spec[SPEC_W0], w1 = s_spec[SPEC_W1];
    const float w2 = s_spec[SPEC_W2], w3 = s_spec[SPEC_W3];
    const float w4 = s_spec[SPEC_W4], etot = s_spec[SPEC_ETOT];
    const float wait = s_spec[SPEC_WAIT], texc = s_spec[SPEC_TEXC];
    for (int i = 0; i < len; ++i) {
      const int s = s0 + i;
      const bool is_last = s == last;
      const float dev_t = s_d[i] / ddiv;
      const float edge_t = (etot - s_e[i]) / ediv;
      const float ship = is_last ? 0.0f : (s == 0 ? inpc : s_b[i]);
      const float xfer = is_last ? 0.0f : latc + ship / bwc;
      const float total = dev_t + xfer + edge_t;
      const float energy = dev_t * dw + xfer * radio + edge_t * ew;
      const float price = edge_t * pps + ship / 1e9f * ppg;
      const float slack = fmaxf(total - deadline, 0.0f);
      const float lat_col = total + (is_last ? 0.0f : wait);
      float scal = w0 * lat_col + w1 * energy + w2 * price + w3 * slack;
      scal = scal + w4 * (total + (is_last ? 0.0f : texc));
      if (scal < best) {                   // strict: ties keep the first
        best = scal;
        idx = s;
      }
    }
  }
  if (live) {
    split_out[e] = idx;
    cost_out[e] = best;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dcum, ecum, bvec [n_splits] f32; the seven env columns [n_envs] f32;
// spec [SPEC_LEN] f32 -> split [n_envs] int32, cost [n_envs] f32.
// n_envs must be > 0.  Returns cudaGetLastError() after the launch.
int decide_split(const void* dcum, const void* ecum, const void* bvec,
                 const void* dev_div, const void* edge_div, const void* bw,
                 const void* lat, const void* inp, const void* dev_w,
                 const void* edge_w, const void* spec, int n_envs,
                 int n_splits, void* split, void* cost, void* stream) {
  const int blocks = (n_envs + THREADS - 1) / THREADS;
  decide_split_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dcum), static_cast<const float*>(ecum),
      static_cast<const float*>(bvec), static_cast<const float*>(dev_div),
      static_cast<const float*>(edge_div), static_cast<const float*>(bw),
      static_cast<const float*>(lat), static_cast<const float*>(inp),
      static_cast<const float*>(dev_w), static_cast<const float*>(edge_w),
      static_cast<const float*>(spec), n_envs, n_splits,
      static_cast<int32_t*>(split), static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
