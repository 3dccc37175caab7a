// Fused offloading decision: the cost of every (environment, split) pair
// and a running first-index argmin per environment.
//
// Replaces: src/repro/kernels/decide_split/kernel.py, decide_split_kernel
// (the Pallas TPU kernel, body _kernel), which walks [block_e, block_s]
// tiles on a sequential grid and carries (min, argmin) in VMEM scratch.
//
// What bounds it on the H100: bytes.  Per environment it reads 7 f32
// columns and writes a split and a cost (36 bytes: 38 MB at E = 2^20, about
// 11 us at 3.35 TB/s); the split rows are shared.  A split costs three FMAs
// and a compare where the deadline weighs nothing (every cost model of the
// decision path), 19 operations otherwise, three of them divisions:
// 0.2 to 0.6 GFLOP at E = 2^20, L = 28, 3 to 9 us at the 67 TFLOP/s of
// non-tensor f32.  The form before this one spent ~30 operations a split,
// four of them IEEE divisions of several instructions each, and was bound
// by issuing them.
//
// Design: one thread per environment, so the argmin needs no communication
// at all: the thread walks every split in order and keeps (best, idx) in
// registers, replacing them only on a strict '<' so ties keep the first
// index (np.argmin semantics, as the Pallas kernel's strict '<' across
// split blocks).  The split rows are staged through shared memory in
// chunks of CHUNK splits, as (dcum[s], etot - ecum[s], bvec[s]), so any L
// works, and every warp reads the same element at once (a broadcast).  The
// [E, L+1] cost tensor never exists, in registers or in memory.  The 12
// scalars of the lowered cost model (SPEC_* below, the layout of pack_spec
// in kernels/decide_split/kernel.py) come in as a small device array.
//
// The algebra: no division in the split loop.  With off = [s != L],
// ship = inp at s = 0 and bvec[s] after, and
//   dev_t = dcum[s] / dev_div, edge_t = (etot - ecum[s]) / edge_div,
//   xfer = off (lat + ship / max(bw, 1)), total = dev_t + xfer + edge_t,
// the plain version's scalar cost
//   w0 (total + off wait) + w1 (dev_t dw + xfer radio + edge_t ew)
//   + w2 (edge_t pps + ship 1e-9 ppg) + w3 max(total - deadline, 0)
//   + w4 (total + off texc)
// regroups per environment into
//   cD dev_t + cE edge_t + cX xfer + cS ship + off K + w3 slack,
//   cD = (w0 + w4) + w1 dw,  cE = (w0 + w4) + w1 ew + w2 pps,
//   cX = (w0 + w4) + w1 radio,  cS = w2 ppg 1e-9,  K = w0 wait + w4 texc,
// and the divisions become products with rdd = 1 / dev_div,
// red = 1 / edge_div and rbw = 1 / max(bw, 1), three divisions an
// environment.  Where w3 = 0 the slack drops out, and with A = rdd cD,
// B = red cE, C = rbw cX + cS, k0 = lat cX + K an offloading split costs
//   dcum[s] A + (etot - ecum[s]) B + ship C + k0
// and s = L costs dcum[L] A + (etot - ecum[L]) B: three FMAs.  For
// non-negative weights every term is non-negative, so the regrouping moves
// the cost by a few f32 roundings (~1e-6 relative) from the plain
// version's, inside the rtol 1e-5 it is held to.  Where w3 != 0, the slack
// max(total - deadline, 0) cancels near the deadline, and a total one
// rounding off (a product with a reciprocal for a division) moved a
// deadline-only cost by 1.2e-3 relative: that path forms dev_t, edge_t,
// xfer and total with the plain version's divisions, the same bits, and
// the weighted sum from the coefficients.  The chosen splits are re-costed
// exactly in f64 by the caller.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// spec vector layout: the cost model's scalar parameters
constexpr int SPEC_RADIO = 0, SPEC_PPS = 1, SPEC_PPG = 2, SPEC_DEADLINE = 3;
constexpr int SPEC_W0 = 4, SPEC_W1 = 5, SPEC_W2 = 6, SPEC_W3 = 7;
constexpr int SPEC_ETOT = 8, SPEC_WAIT = 9, SPEC_TEXC = 10, SPEC_W4 = 11;
constexpr int SPEC_LEN = 12;
constexpr int CHUNK = 256;    // splits staged in shared memory per pass
constexpr int THREADS = 256;

// One environment's coefficients (see the algebra above).
struct Env {
  float ddiv, ediv, bwc, lat, inp;   // the columns the slack path reads
  float cD, cE, cX, cS, K;           // weights of dev_t, edge_t, xfer, ship
  float A, B, C, k0;                 // the w3 = 0 form
  float w3, deadline;
};

// The scalar cost of split (d = dcum[s], eh = etot - ecum[s], ship), an
// offloading split when off.
template <bool SLACK>
__device__ __forceinline__ float split_cost(const Env& v, float d, float eh,
                                            float ship, bool off) {
  if (!SLACK)
    return off ? fmaf(d, v.A, fmaf(eh, v.B, fmaf(ship, v.C, v.k0)))
               : fmaf(d, v.A, eh * v.B);
  // the plain version's total, bit for bit: the slack cancels against it
  const float dev_t = d / v.ddiv, edge_t = eh / v.ediv;
  const float xfer = off ? v.lat + ship / v.bwc : 0.0f;
  const float total = dev_t + xfer + edge_t;
  const float moved = off ? fmaf(xfer, v.cX, fmaf(ship, v.cS, v.K)) : 0.0f;
  return fmaf(v.w3, fmaxf(total - v.deadline, 0.0f),
              fmaf(dev_t, v.cD, fmaf(edge_t, v.cE, moved)));
}

// Every split in order, the rows staged chunk by chunk; (best, idx) is the
// first split of least cost.  Every thread of the block calls it (it
// synchronises the block); those past n_envs only stage.
template <bool SLACK>
__device__ __forceinline__ void walk_splits(
    const float* __restrict__ dcum, const float* __restrict__ ecum,
    const float* __restrict__ bvec, float etot, int n_splits, const Env& v,
    bool live, float4* s_row, float& best, int& idx) {
  const int last = n_splits - 1;           // split == L: nothing offloaded
  best = INFINITY;
  idx = 0;
  auto take = [&](float c, int s) {
    if (c < best) {                        // strict: ties keep the first
      best = c;
      idx = s;
    }
  };
  for (int s0 = 0; s0 < n_splits; s0 += CHUNK) {
    const int len = min(CHUNK, n_splits - s0);
    __syncthreads();                       // previous chunk fully read
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      s_row[i] = make_float4(dcum[s0 + i], etot - ecum[s0 + i],
                             bvec[s0 + i], 0.0f);
    __syncthreads();
    if (!live) continue;
    int lo = 0, hi = len;
    if (s0 == 0) {                         // s = 0 ships the input
      const float4 r = s_row[0];
      take(split_cost<SLACK>(v, r.x, r.y, v.inp, last != 0), 0);
      lo = 1;
    }
    const bool has_last = last > 0 && s0 + len - 1 == last;
    if (has_last) hi = len - 1;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const float4 r = s_row[i];
      take(split_cost<SLACK>(v, r.x, r.y, r.z, true), s0 + i);
    }
    if (has_last) {
      const float4 r = s_row[len - 1];
      take(split_cost<SLACK>(v, r.x, r.y, 0.0f, false), last);
    }
  }
}

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
  __shared__ float4 s_row[CHUNK];
  __shared__ float s_spec[SPEC_LEN];
  if (threadIdx.x < SPEC_LEN) s_spec[threadIdx.x] = spec[threadIdx.x];
  __syncthreads();
  const float w0 = s_spec[SPEC_W0], w1 = s_spec[SPEC_W1];
  const float w2 = s_spec[SPEC_W2], w4 = s_spec[SPEC_W4];
  const float wl = w0 + w4;                // latency and tail weigh total

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < n_envs;
  Env v;
  float dw = 0.0f, ew = 0.0f;
  v.ddiv = v.ediv = v.bwc = 1.0f;
  v.lat = v.inp = 0.0f;
  if (live) {
    v.ddiv = dev_div[e];
    v.ediv = edge_div[e];
    v.bwc = fmaxf(bw[e], 1.0f);
    v.lat = lat[e];
    v.inp = inp[e];
    dw = dev_w[e];
    ew = edge_w[e];
  }
  const float rdd = 1.0f / v.ddiv;          // w3 = 0: the only divisions
  const float red = 1.0f / v.ediv, rbw = 1.0f / v.bwc;
  v.cD = fmaf(w1, dw, wl);
  v.cE = fmaf(w2, s_spec[SPEC_PPS], fmaf(w1, ew, wl));
  v.cX = fmaf(w1, s_spec[SPEC_RADIO], wl);
  v.cS = w2 * s_spec[SPEC_PPG] * 1e-9f;
  v.K = fmaf(w0, s_spec[SPEC_WAIT], w4 * s_spec[SPEC_TEXC]);
  v.A = rdd * v.cD;
  v.B = red * v.cE;
  v.C = fmaf(rbw, v.cX, v.cS);
  v.k0 = fmaf(v.lat, v.cX, v.K);
  v.w3 = s_spec[SPEC_W3];
  v.deadline = s_spec[SPEC_DEADLINE];
  const float etot = s_spec[SPEC_ETOT];

  float best;
  int idx;
  if (v.w3 != 0.0f)                        // the same branch for every thread
    walk_splits<true>(dcum, ecum, bvec, etot, n_splits, v, live, s_row,
                      best, idx);
  else
    walk_splits<false>(dcum, ecum, bvec, etot, n_splits, v, live, s_row,
                       best, idx);
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
