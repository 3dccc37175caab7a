// Chunked Mamba2 SSD scan: per (batch, head) row, sequential over chunks of
// Q steps, carrying the [P, N] state.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py, ssd_scan_kernel (the
// Pallas TPU kernel, body _kernel), whose grid (B*H, nc) runs the chunk
// dimension innermost and keeps the state in VMEM scratch.
//
// Per chunk, with csum the inclusive cumsum of log a over the chunk and
// total = csum[Q-1]:
//   y[t]  = sum_{s<=t} (C_t . B_s) exp(csum[t] - csum[s]) xdt[s]
//         + exp(csum[t]) (C_t . H)                        (H is [P, N])
//   H'    = exp(total) H + sum_s xdt[s] (B_s exp(total - csum[s]))^T
// B and C are shared by the heads of a batch row (the Pallas index i // h).
//
// What bounds it on the H100: operations.  At B 4, H 64, S 2048, P = N = 64,
// Q = 128 it does ~26 GFLOP in f32 against ~0.3 GB (xdt and y in f32):
// ~90 operations per byte, above the f32 line of the CUDA cores
// (67 TFLOP/s over 3.35 TB/s = 20).  It works in full f32 on the CUDA
// cores, as the reference does; TF32 tensor cores would cut the mantissa
// to 10 bits.
//
// Design: one block of 256 threads per (batch, head) row, walking the
// chunks in order.  Shared memory holds the chunk's xdt [Q][P], B^T [N][Q],
// C [Q][N], the gated score tile G [Q][Q], the state (transposed, [N][P])
// and the chunk's csum and exp(total - csum): 178 KB at the capacities
// Q = 128, P = N = 64, so the launcher opts in to more than the 48 KB
// default.  Each phase is a register-tiled product (each thread 8x8, 8x4 or
// 4x4 outputs, reading shared memory along conflict-free padded strides).
// exp(csum[t] - csum[s]) is formed only for s <= t, where it is <= 1.  Steps
// past the sequence's end load as dt = 0 (decay 1, input 0), which is what
// padding to a multiple of Q gives the reference, and are not stored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QC = 128;  // chunk capacity
constexpr int PC = 64;   // head-dim capacity
constexpr int NC = 64;   // state-dim capacity
constexpr int NT = 256;  // threads: 16 row groups x 16 lanes
constexpr int GS = QC + 1;
constexpr int BS = QC + 1;
constexpr int CS = NC + 1;
constexpr size_t SMEM =
    sizeof(float) * ((size_t)QC * PC + (size_t)NC * BS + (size_t)QC * CS +
                     (size_t)NC * PC + (size_t)QC * GS + 2 * QC);

__global__ void __launch_bounds__(NT)
    ssd_scan(const float* __restrict__ xdt, const float* __restrict__ loga,
             const float* __restrict__ bmat, const float* __restrict__ cmat,
             float* __restrict__ y, float* __restrict__ state, int seq,
             int nh, int p, int n, int q) {
  extern __shared__ float smem[];
  float* X = smem;             // [QC][PC]  xdt of the chunk
  float* Bt = X + QC * PC;     // [NC][BS]  B of the chunk, transposed
  float* Cs = Bt + NC * BS;    // [QC][CS]  C of the chunk
  float* St = Cs + QC * CS;    // [NC][PC]  state, transposed
  float* G = St + NC * PC;     // [QC][GS]  (C B^T) o decay, causal
  float* csum = G + QC * GS;   // [QC]
  float* dout = csum + QC;     // [QC]      exp(total - csum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bb = blockIdx.x / nh, hh = blockIdx.x % nh;
  const long long row_stride = (long long)nh * p;  // xdt/y: one step

  for (int i = tid; i < NC * PC; i += NT) St[i] = 0.f;

  for (int c0 = 0; c0 < seq; c0 += q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < QC * PC; i += NT) {
      const int t = i / PC, pp = i % PC;
      const bool ok = t < q && c0 + t < seq && pp < p;
      X[i] = ok ? xdt[((long long)bb * seq + c0 + t) * row_stride +
                      (long long)hh * p + pp]
                : 0.f;
    }
    for (int i = tid; i < QC * NC; i += NT) {
      const int t = i / NC, nn = i % NC;
      const bool ok = t < q && c0 + t < seq && nn < n;
      const long long at = ((long long)bb * seq + c0 + t) * n + nn;
      Bt[nn * BS + t] = ok ? bmat[at] : 0.f;
      Cs[t * CS + nn] = ok ? cmat[at] : 0.f;
    }
    if (tid < QC) {
      const bool ok = tid < q && c0 + tid < seq;
      csum[tid] = ok ? loga[((long long)bb * seq + c0 + tid) * nh + hh] : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of log a over the chunk: warp 0, 4 steps a lane
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run += csum[tid * 4 + j];
        v[j] = run;
      }
      float pre = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, off);
        if (tid >= off) pre += o;
      }
      const float excl = pre - run;
#pragma unroll
      for (int j = 0; j < 4; ++j) csum[tid * 4 + j] = v[j] + excl;
    }
    __syncthreads();
    const float total = csum[QC - 1];  // steps past q or seq add 0
    if (tid < QC) dout[tid] = expf(total - csum[tid]);

    // G[t][s] = (C_t . B_s) exp(csum[t] - csum[s]) for s <= t, else 0
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int nn = 0; nn < n; ++nn) {
        float bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bt[nn * BS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float cv = Cs[(ty * 8 + i) * CS + nn];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv, bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty * 8 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          G[t * GS + s] = s <= t ? acc[i][j] * expf(csum[t] - csum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = G[t] . X[:, p] + exp(csum[t]) (C_t . H[p])
    {
      float intra[8][4], inter[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) intra[i][j] = inter[i][j] = 0.f;
      const int s_end = min(q, ty * 8 + 8);  // G is 0 past the thread's rows
      for (int s = 0; s < s_end; ++s) {
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = X[s * PC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float g = G[(ty * 8 + i) * GS + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(g, xv[j], intra[i][j]);
        }
      }
      for (int nn = 0; nn < n; ++nn) {
        float sv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[nn * PC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float cv = Cs[(ty * 8 + i) * CS + nn];
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv, sv[j], inter[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty * 8 + i;
        if (t >= q || c0 + t >= seq) continue;
        const float din = expf(csum[t]);
        float* yr = y + ((long long)bb * seq + c0 + t) * row_stride +
                    (long long)hh * p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = tx + 16 * j;
          if (pp < p) yr[pp] = intra[i][j] + din * inter[i][j];
        }
      }
    }
    __syncthreads();

    // H'[p][n] = exp(total) H[p][n] + sum_s X[s][p] B[s][n] dout[s]
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < q; ++s) {
        const float w = dout[s];
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = X[s * PC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bw = Bt[(ty * 4 + i) * BS + s] * w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bw, xv[j], acc[i][j]);
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* cell = St + (ty * 4 + i) * PC + tx + 16 * j;
          *cell = decay * *cell + acc[i][j];
        }
    }
  }
  __syncthreads();
  float* sb = state + ((long long)bb * nh + hh) * p * n;
  for (int i = tid; i < p * n; i += NT) {
    const int pp = i / n, nn = i % n;
    sb[i] = St[nn * PC + pp];
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], all f32 and contiguous ->
// y [B,S,H,P] and the final state [B,H,P,N], f32.  chunk <= 128, P <= 64,
// N <= 64.  Returns the launch's cudaError_t.
int ssm_scan(const void* xdt, const void* loga, const void* b, const void* c,
             void* y, void* state, int bsz, int seq, int nh, int p, int n,
             int chunk, void* stream) {
  if (chunk < 1 || chunk > QC || p < 1 || p > PC || n < 1 || n > NC)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  ssd_scan<<<bsz * nh, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(state), seq, nh, p, n,
      chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
