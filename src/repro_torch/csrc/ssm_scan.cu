// Chunked Mamba2 SSD scan, chunk-parallel: every (batch, head, chunk) is a
// block of its own, and only the [P, N] state is handed from chunk to chunk.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py, ssd_scan_kernel (the
// Pallas TPU kernel, body _kernel), whose grid (B*H, nc) runs the chunk
// dimension innermost and keeps the state in VMEM scratch.
//
// Per chunk, with csum the inclusive cumsum of log a over the chunk and
// total = csum[Q-1]:
//   y[t]  = sum_{s<=t} (C_t . B_s) exp(csum[t] - csum[s]) xdt[s]
//         + exp(csum[t]) (C_t . H)              (H: the state before it)
//   H'    = exp(total) H + S,   S = sum_s xdt[s] (B_s exp(total - csum[s]))^T
// B and C are shared by the heads of a batch row (the Pallas index i // h).
//
// What bounds it on the H100: operations.  At B 4, H 64, S 2048, P = N = 64,
// Q = 128 the function needs ~13.0 GFLOP in f32 (C.B^T once per batch row
// and chunk; per head and chunk the causal product with xdt, S and C.H)
// against ~0.28 GB (xdt and y in f32): ~46 operations per byte, above the
// f32 line of the CUDA cores (67 TFLOP/s over 3.35 TB/s = 20).  It works in
// full f32 on the CUDA cores, as the reference does; TF32 tensor cores would
// cut the mantissa to 10 bits.
//
// Design, SSD's own decomposition in two kernels:
//  ssd_cb     one block per (batch row, chunk): C.B^T [Q][Q], computed once
//             and read by the heads' blocks (4 MB at zamba2's prefill, from
//             L2), not once per head.
//  ssd_chunk  one block per (batch, head, chunk), 4,096 blocks of 256
//             threads at 99 KB of shared memory, two an SM.  A block takes a
//             ticket from a counter when it starts and works on the chunk the
//             ticket names, chunk-major, so every chunk's predecessor started
//             before it.  It computes, on its own: the cumsum of log a, the
//             intra-chunk output (C.B^T o causal decay) . xdt, and the
//             chunk's state contribution S.  Then the only sequential part:
//             it waits until the previous chunk of its row has published H
//             (a per-row counter, read with acquire), forms H' = exp(total) H
//             + S, publishes it (written, fenced, the counter released) and
//             only then adds exp(csum) C . H to its output.  H travels
//             through a two-slot ring per row (8 MB at zamba2's prefill):
//             chunk c reads slot (c-1)&1, and chunk c+1 overwrites it only
//             after waiting for chunk c.  Nothing is added with atomics, so
//             every run gives the same bits.
// The products are register-tiled (each thread 2 x 4x4 or 4x4 outputs,
// float4 reads of shared memory); the intra product gives each thread one
// block of 4 rows near the top of the causal triangle and one near the
// bottom, so every thread walks 132 steps.  exp(csum[t] - csum[s]) is formed
// only for s <= t, where it is <= 1, as 2^((csum[t] - csum[s]) log2 e) on the
// special-function unit.  Steps past the sequence's end load as
// dt = 0 (decay 1, input 0), which is what padding to a multiple of Q gives
// the reference, and are not stored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QC = 128;       // chunk capacity
constexpr int PC = 64;        // head-dim capacity
constexpr int NC = 64;        // state-dim capacity
constexpr int NT = 256;       // threads: 16 row groups x 16 column groups
constexpr int TP = QC + 4;    // pitch of the [.][t] tiles (16-byte rows)
constexpr size_t CB_SMEM = sizeof(float) * 2 * NC * TP;
// X [QC][PC] (later H^T [NC][PC]); W: G^T [QC][TP], later B*dout [QC][NC]
// and C^T * exp(csum) [NC][TP]; csum, dout, exp(csum), csum log2(e) [QC]
constexpr size_t CHUNK_SMEM =
    sizeof(float) * ((size_t)QC * PC + (size_t)QC * TP + 4 * QC);
static_assert(QC * NC + NC * TP <= QC * TP, "W holds B*dout and C^T");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Where element (n, t) of C^T and 4-column group q of row n of H^T lie: the
// 16-byte groups of a row are permuted by the row, so that the transposing
// stores spread over the banks (2-way at most) while the products still read
// 4 consecutive t or p as one float4
__device__ __forceinline__ int ct_at(int n, int t) {
  return n * TP + 4 * ((t >> 2) ^ ((n >> 2) & 7)) + (t & 3);
}
__device__ __forceinline__ int ht_at(int n, int q) {
  return n * PC + 4 * (q ^ ((n >> 2) & 15));
}

// 2^x on the special-function unit (relative error ~2^-22), one operation
// for each of G^T's 8,192 decays a block, where expf takes several
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// load(k) for k in [0, PER), then store(k, value), U at a time: U loads are
// in flight together (a loop that stores each value before the next load
// waits out the memory's latency at every element)
template <int PER, int U = 8, class Load, class Store>
__device__ __forceinline__ void staged(Load load, Store store) {
  static_assert(PER % U == 0, "whole groups");
#pragma unroll 1
  for (int k0 = 0; k0 < PER; k0 += U) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load(k0 + u);
#pragma unroll
    for (int u = 0; u < U; ++u) store(k0 + u, v[u]);
  }
}

struct BC4 {
  float4 b, c;
};

// cb[b][c][s][t] = C_t . B_s over the chunk's valid steps, 0 elsewhere
__global__ void __launch_bounds__(NT)
    ssd_cb(const float* __restrict__ bmat, const float* __restrict__ cmat,
           float* __restrict__ cb, int seq, int n, int q, int nc) {
  extern __shared__ float smem[];
  float* Bt = smem;              // [NC][TP]  B of the chunk, transposed
  float* Ct = Bt + NC * TP;      // [NC][TP]  C of the chunk, transposed
  const int c = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int c0 = c * q, valid = min(q, seq - c0);
  staged<QC * NC / NT>(
      [&](int k) {
        const int i = tid + k * NT, t = i / NC, nn = i % NC;
        const long long at = ((long long)bb * seq + c0 + t) * n + nn;
        return t < valid && nn < n
                   ? make_float2(__ldg(bmat + at), __ldg(cmat + at))
                   : make_float2(0.f, 0.f);
      },
      [&](int k, float2 v) {
        const int i = tid + k * NT, t = i / NC, nn = i % NC;
        Bt[nn * TP + t] = v.x;
        Ct[nn * TP + t] = v.y;
      });
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;  // rows s = 8ty.., columns t
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int nn = 0; nn < n; ++nn) {
    const float4 b0 = ld4(Bt + nn * TP + 8 * ty);
    const float4 b1 = ld4(Bt + nn * TP + 8 * ty + 4);
    const float4 c0v = ld4(Ct + nn * TP + 4 * tx);
    const float4 c1v = ld4(Ct + nn * TP + 64 + 4 * tx);
    const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float cs[8] = {c0v.x, c0v.y, c0v.z, c0v.w,
                         c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bs[i], cs[j], acc[i][j]);
  }
  float* out = cb + ((long long)bb * nc + c) * QC * QC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (8 * ty + i) * QC;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// csum <- its inclusive cumsum over the chunk, once every thread has
// written its step: warp 0, 4 steps a lane
__device__ __forceinline__ void csum_scan(float* csum) {
  const int tid = threadIdx.x;
  __syncthreads();
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
}

// csum[t] = the inclusive cumsum of log a over the chunk (steps past valid
// add 0)
__device__ __forceinline__ void chunk_csum(const float* __restrict__ loga,
                                           long long step0, int nh, int hh,
                                           int valid, float* csum) {
  const int tid = threadIdx.x;
  if (tid < QC)
    csum[tid] = tid < valid ? __ldg(loga + (step0 + tid) * nh + hh) : 0.f;
  csum_scan(csum);
}

// Ct[ct_at(n, t)] = C[t][n] ecs[t] and Bd[t][n] = B[t][n] dout[t]
template <bool VEC>
__device__ __forceinline__ void load_bc(const float* __restrict__ bmat,
                                        const float* __restrict__ cmat,
                                        long long step0, int n, int valid,
                                        const float* dout, const float* ecs,
                                        float* Bd, float* Ct) {
  const int tid = threadIdx.x;
  if (VEC) {
    staged<QC * NC / 4 / NT>(
        [&](int k) {
          const int i = tid + k * NT, t = i / (NC / 4);
          const long long at = (step0 + t) * (NC / 4) + i % (NC / 4);
          BC4 v;
          v.b = v.c = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < valid) {
            v.b = __ldg(reinterpret_cast<const float4*>(bmat) + at);
            v.c = __ldg(reinterpret_cast<const float4*>(cmat) + at);
          }
          return v;
        },
        [&](int k, BC4 v) {
          const int i = tid + k * NT, t = i / (NC / 4), nn = 4 * (i % (NC / 4));
          const float e = ecs[t], d = dout[t];
          *reinterpret_cast<float4*>(Bd + t * NC + nn) =
              make_float4(v.b.x * d, v.b.y * d, v.b.z * d, v.b.w * d);
          Ct[ct_at(nn, t)] = v.c.x * e;
          Ct[ct_at(nn + 1, t)] = v.c.y * e;
          Ct[ct_at(nn + 2, t)] = v.c.z * e;
          Ct[ct_at(nn + 3, t)] = v.c.w * e;
        });
  } else {
    staged<QC * NC / NT>(
        [&](int k) {
          const int i = tid + k * NT, t = i / NC, nn = i % NC;
          const long long at = (step0 + t) * n + nn;
          const bool ok = t < valid && nn < n;
          return make_float2(ok ? __ldg(bmat + at) : 0.f,
                             ok ? __ldg(cmat + at) : 0.f);
        },
        [&](int k, float2 v) {
          const int i = tid + k * NT, t = i / NC, nn = i % NC;
          Bd[i] = v.x * dout[t];
          Ct[ct_at(nn, t)] = v.y * ecs[t];
        });
  }
}

// H^T[n][p] into X's place at ht_at, from H[4ty+i][4tx+j] = h[i][j]
__device__ __forceinline__ void store_ht(float* X, const float (&h)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(X + ht_at(4 * tx + j, ty)) =
        make_float4(h[0][j], h[1][j], h[2][j], h[3][j]);
}

// ya/yb += exp(csum[t]) C_t . H on the thread's rows ra.., rb.. and
// columns 4tx.. (Ct holds C exp(csum), X holds H^T)
__device__ __forceinline__ void inter_product(const float* X, const float* Ct,
                                              int n, int ra, int rb,
                                              float (&ya)[4][4],
                                              float (&yb)[4][4]) {
  const int tx = threadIdx.x % 16;
  for (int nn = 0; nn < n; ++nn) {
    const float4 h = ld4(X + ht_at(nn, tx));
    const float4 ca = ld4(Ct + ct_at(nn, ra)), cbv = ld4(Ct + ct_at(nn, rb));
    const float hv[4] = {h.x, h.y, h.z, h.w};
    const float cas[4] = {ca.x, ca.y, ca.z, ca.w};
    const float cbs[4] = {cbv.x, cbv.y, cbv.z, cbv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ya[i][j] = fmaf(cas[i], hv[j], ya[i][j]);
        yb[i][j] = fmaf(cbs[i], hv[j], yb[i][j]);
      }
  }
}

// the thread's rows of y
template <bool VEC>
__device__ __forceinline__ void store_y(float* __restrict__ y, long long step0,
                                        long long row_stride, int hh, int p,
                                        int valid, int ra, int rb,
                                        const float (&ya)[4][4],
                                        const float (&yb)[4][4]) {
  const int tx = threadIdx.x % 16;
  const auto row = [&](int t, const float(&v)[4]) {
    if (t >= valid) return;
    float* yr = y + (step0 + t) * row_stride + (long long)hh * p;
    if (VEC) {
      *reinterpret_cast<float4*>(yr + 4 * tx) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + j < p) yr[4 * tx + j] = v[j];
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row(ra + i, ya[i]);
    row(rb + i, yb[i]);
  }
}

// VEC: P = N = 64 and 16-byte aligned rows, read and written as float4.
// SAVE: also write the state each chunk starts from to hsave
// [B*H][nc][PC][NC] (for the backward); off, nothing else changes.
template <bool VEC, bool SAVE>
__global__ void __launch_bounds__(NT, 2)
    ssd_chunk(const float* __restrict__ xdt, const float* __restrict__ loga,
              const float* __restrict__ bmat, const float* __restrict__ cmat,
              const float* __restrict__ cb, float* __restrict__ y,
              float* __restrict__ state, float* hbuf, int* ticket, int* done,
              float* __restrict__ hsave, int bsz, int seq, int nh, int p,
              int n, int q, int nc) {
  extern __shared__ float smem[];
  float* X = smem;               // [QC][PC]  xdt; later H^T [NC][PC] (ht_at)
  float* W = X + QC * PC;        // G^T [QC][TP]; later Bd and Ct below
  float* Bd = W;                 // [QC][NC]  B * exp(total - csum)
  float* Ct = W + QC * NC;       // [NC][TP]  C^T * exp(csum), at ct_at
  float* csum = W + QC * TP;     // [QC]
  float* dout = csum + QC;       // [QC]      exp(total - csum)
  float* ecs = dout + QC;        // [QC]      exp(csum)
  float* lcs = ecs + QC;         // [QC]      csum * log2(e)
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int rows = bsz * nh;
  const int c = s_ticket / rows, bh = s_ticket % rows;
  const int bb = bh / nh, hh = bh % nh;
  const int c0 = c * q, valid = min(q, seq - c0);
  const long long step0 = (long long)bb * seq + c0;  // first step's row
  const long long row_stride = (long long)nh * p;    // xdt/y: one step

  if (VEC) {
    staged<QC * PC / 4 / NT>(
        [&](int k) {
          const int i = tid + k * NT, t = i / (PC / 4);
          return t < valid
                     ? __ldg(reinterpret_cast<const float4*>(
                                 xdt + (step0 + t) * row_stride +
                                 (long long)hh * PC) +
                             i % (PC / 4))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        },
        [&](int k, float4 v) {
          reinterpret_cast<float4*>(X)[tid + k * NT] = v;
        });
  } else {
    staged<QC * PC / NT>(
        [&](int k) {
          const int i = tid + k * NT, t = i / PC, pp = i % PC;
          return t < valid && pp < p
                     ? __ldg(xdt + (step0 + t) * row_stride +
                             (long long)hh * p + pp)
                     : 0.f;
        },
        [&](int k, float v) { X[tid + k * NT] = v; });
  }
  chunk_csum(loga, step0, nh, hh, valid, csum);
  const float total = csum[QC - 1];  // steps past valid add 0
  if (tid < QC) {
    dout[tid] = expf(total - csum[tid]);
    ecs[tid] = expf(csum[tid]);
    lcs[tid] = csum[tid] * 1.4426950408889634f;
  }
  __syncthreads();

  // G^T[s][t] = (C_t . B_s) exp(csum[t] - csum[s]) for s <= t, else 0
  const float4* cbc = reinterpret_cast<const float4*>(
      cb + ((long long)bb * nc + c) * QC * QC);
  staged<QC * QC / 4 / NT>(
      [&](int k) {
        const int i = tid + k * NT, s = i / (QC / 4), t = 4 * (i % (QC / 4));
        return t + 3 >= s ? __ldg(cbc + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      },
      [&](int k, float4 v) {
        const int i = tid + k * NT, s = i / (QC / 4), t = 4 * (i % (QC / 4));
        const float ls = lcs[s];
        const float4 g = make_float4(
            s <= t ? v.x * fast_exp2(lcs[t] - ls) : 0.f,
            s <= t + 1 ? v.y * fast_exp2(lcs[t + 1] - ls) : 0.f,
            s <= t + 2 ? v.z * fast_exp2(lcs[t + 2] - ls) : 0.f,
            s <= t + 3 ? v.w * fast_exp2(lcs[t + 3] - ls) : 0.f);
        *reinterpret_cast<float4*>(W + s * TP + t) = g;
      });
  __syncthreads();

  // intra-chunk output: rows ra = 4ty.. (s <= 4ty+3) and rb = 124-4ty..
  // (s <= 127-4ty), columns 4tx..: 132 steps for every thread
  const int ra = 4 * ty, rb = QC - 4 - 4 * ty;
  float ya[4][4], yb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ya[i][j] = yb[i][j] = 0.f;
  {
    const int sa = min(ra + 4, valid), sb = min(rb + 4, valid);
    int s = 0;
    for (; s < sa; ++s) {
      const float4 x = ld4(X + s * PC + 4 * tx);
      const float4 ga = ld4(W + s * TP + ra), gb = ld4(W + s * TP + rb);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float gas[4] = {ga.x, ga.y, ga.z, ga.w};
      const float gbs[4] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ya[i][j] = fmaf(gas[i], xs[j], ya[i][j]);
          yb[i][j] = fmaf(gbs[i], xs[j], yb[i][j]);
        }
    }
    for (; s < sb; ++s) {
      const float4 x = ld4(X + s * PC + 4 * tx);
      const float4 gb = ld4(W + s * TP + rb);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float gbs[4] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yb[i][j] = fmaf(gbs[i], xs[j], yb[i][j]);
    }
  }
  __syncthreads();  // G^T is read; W takes Bd and Ct

  load_bc<VEC>(bmat, cmat, step0, n, valid, dout, ecs, Bd, Ct);
  __syncthreads();

  // the chunk's own state contribution S[p][n], p = 4ty.., n = 4tx..
  float hs[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hs[i][j] = 0.f;
  for (int s = 0; s < valid; ++s) {
    const float4 x = ld4(X + s * PC + 4 * ty);
    const float4 bw = ld4(Bd + s * NC + 4 * tx);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float bs[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hs[i][j] = fmaf(xs[i], bs[j], hs[i][j]);
  }

  // the hand-off: H of the previous chunk, then H' = exp(total) H + S
  float hprev[4][4];
  if (c > 0) {
    if (tid == 0) {
      while (load_acquire(done + bh) < c) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();  // also: every read of X is done
    const float* hb = hbuf + ((long long)((c - 1) & 1) * rows + bh) * PC * NC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldcg(
          reinterpret_cast<const float4*>(hb + (4 * ty + i) * NC + 4 * tx));
      hprev[i][0] = v.x, hprev[i][1] = v.y, hprev[i][2] = v.z;
      hprev[i][3] = v.w;
    }
  } else {
    __syncthreads();  // every read of X is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hprev[i][j] = 0.f;
  }
  if (SAVE) {
    float* hs = hsave + ((long long)bh * nc + c) * PC * NC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(hs + (4 * ty + i) * NC + 4 * tx) =
          make_float4(hprev[i][0], hprev[i][1], hprev[i][2], hprev[i][3]);
  }
  const float decay = expf(total);
  float hnew[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hnew[i][j] = decay * hprev[i][j] + hs[i][j];
  if (c == nc - 1) {
    float* st = state + (long long)bh * p * n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = 4 * ty + i, nn = 4 * tx + j;
        if (pp < p && nn < n) st[pp * n + nn] = hnew[i][j];
      }
  } else {
    float* hb = hbuf + ((long long)(c & 1) * rows + bh) * PC * NC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      __stcg(reinterpret_cast<float4*>(hb + (4 * ty + i) * NC + 4 * tx),
             make_float4(hnew[i][0], hnew[i][1], hnew[i][2], hnew[i][3]));
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(done + bh, c + 1);
  }
  store_ht(X, hprev);
  __syncthreads();
  inter_product(X, Ct, n, ra, rb, ya, yb);
  store_y<VEC>(y, step0, row_stride, hh, p, valid, ra, rb, ya, yb);
}

// ---------------------------------------------------------------------------
// The backward.  Replaces what the reference differentiates with jax.vjp:
// ssd_chunked (src/repro/models/mamba2.py), whose chunked form the Pallas
// kernel ssd_scan_kernel computes.  Per chunk, with dy the cotangent of y,
// dH that of the state after the chunk, L[t][s] = exp(csum[t] - csum[s])
// for s <= t (else 0), DX[t][s] = dy_t . xdt_s and W = L o DX:
//   dH_prev  = exp(total) dH + sum_t exp(csum[t]) dy_t (x) C_t
//   dxdt_s   = sum_t (C_t . B_s) L[t][s] dy_t + exp(total - csum[s]) dH B_s
//   dC_t     = sum_s W[t][s] B_s + exp(csum[t]) dy_t H_prev
//   dB_s     = sum_t W[t][s] C_t + exp(total - csum[s]) xdt_s dH
//   dcsum[t] = sum_s (C.B)[t][s] W[t][s] - sum_u (C.B)[u][t] W[u][t]
//            + C_t . (exp(csum[t]) dy_t H_prev)
//            - B_t . (exp(total - csum[t]) xdt_t dH)
//            + [t = Q-1] sum(dH o H_new)
//   dloga    = the reverse cumsum of dcsum within the chunk
// dB and dC are summed over the heads (B and C are shared by them).
//
// What bounds it on the H100: operations.  At zamba2's B 4, S 2048 it needs
// 34.6 GFLOP of f32 (kernels/work.py:ssm_bwd_work; 0.516 ms at 67 TFLOP/s)
// against ~0.37 GB.  Its products are all tile products of 128 x 128 x 64
// or 128 x 64 x 64, which the tensor cores run; but TF32 keeps 10 bits of
// mantissa, and the backward is held to f32 (1e-4 of each gradient's
// scale; one TF32 product is ~5e-4 off, tests/test_torch_ssm_scan.py).  So
// ssd_bwd_chunk runs every product as split TF32: each f32 operand is a
// TF32 high part plus the remainder, and a.b = hi.hi + hi.lo + lo.hi, each
// an mma.sync.m16n8k8 into f32 (the lo.lo term, 2^-22 of the product, is
// dropped).  Three TF32 products of 34.6 GFLOP at 495 TFLOP/s: 0.21 ms.
//
// ssd_bwd_chain  the reverse chain: one block per (batch, head, chunk),
//                tickets handed out from the last chunk down (so every
//                chunk's successor started first).  A block forms its
//                chunk's sum_t exp(csum[t]) dy_t (x) C_t on its own, waits
//                for the chunk after it to publish dH, writes dH_prev for
//                the chunk before it and releases the row's counter.  dh
//                [B*H][nc][64][64] ends holding every chunk's dH, the last
//                one the final state's cotangent.  A block's dy and C
//                arrive in one batch of copies (cp.async); its product
//                stays on the CUDA cores: on the tensor cores (split
//                TF32), and as a parallel pass with the decay-and-add left
//                to the last block of a row, the chain measured slower
//                (PERF.md).
// ssd_bwd_chunk  one block per (batch row, chunk, group of heads), 8 warps.
//                B and C of the chunk are loaded once for the group's
//                heads; a head's xdt, dy, H_prev and dH in one batch of
//                copies straight into shared memory (cp.async).  No [Q][Q]
//                tile is kept: warp w owns rows 16w.. of the chunk twice.
//                As t rows it walks the causal s tiles two at a time,
//                forming DX on the tensor cores (a tile's three split
//                products in three accumulators, three independent
//                chains), W = L o DX and its share of dcsum in registers,
//                and feeds W straight back as the A operand of W B (an
//                accumulator tile is an A fragment once its k order is
//                permuted: columns 2q, 2q + 1 of the tile are k = q,
//                q + 4, and B's rows are read in the same order).  As s
//                rows it walks the t tiles again for DX^T, giving W^T C and
//                G^T dy (G = (C.B) o L, C.B read from the forward's tile
//                in L2).  The state terms are four products with H_prev or
//                dH.  dB and dC stay in registers across the group's heads,
//                added in head order; each group writes its share, added
//                up by the caller in group order.  dloga per head, from
//                the row sums in registers, reduced over the 4 lanes of a
//                row and then in fixed orders: every run gives the same
//                bits.  ~176 KB of shared memory and 250-255 registers a
//                thread: one block an SM, 8 warps, whose dependent mma
//                chains the SM cannot hide (PERF.md); 16 warps at 128
//                registers spilled.

constexpr int XP = PC + 4;    // pitch of the [Q][P or N] tiles (4 mod 32)
constexpr int HP = NC + 8;    // pitch of the [P][N] tiles (8 mod 32)
constexpr size_t BWD_CHAIN_SMEM = sizeof(float) * (2 * QC * PC + QC);
constexpr size_t BWD_CHUNK_SMEM =
    sizeof(float) * (4 * (size_t)QC * XP + 2 * (size_t)PC * HP + 7 * QC);

// an f32 operand as a TF32 high part, x rounded to nearest at 10 mantissa
// bits (ties away from zero, as cvt.rna.tf32.f32, in two integer
// operations), and the remainder x - hi, exact in f32, of which the tensor
// cores read the TF32 bits (its low 13 bits, 2^-21 of x at most, are
// ignored)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// the fragments of mma.m16n8k8, lane 4g + q: A holds rows g, g + 8 at k q,
// q + 4 (a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)); B
// holds k q, q + 4 of column g; the accumulator rows g, g + 8 at columns
// 2q, 2q + 1 (c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8,
// 2q + 1))
struct FragA {
  Split v[4];
};
struct FragB {
  Split v[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: lo.hi, hi.lo, then hi.hi (lo.lo dropped)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi,
           b.v[1].hi);
  mma_tf32(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo,
           b.v[1].lo);
  mma_tf32(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi,
           b.v[1].hi);
}

// the three products of mma3 into three accumulators: three chains of
// dependent mma.sync where mma3 makes one
__device__ __forceinline__ void mma3_apart(float (&hh)[4], float (&lh)[4],
                                           float (&hl)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(lh, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi,
           b.v[1].hi);
  mma_tf32(hl, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo,
           b.v[1].lo);
  mma_tf32(hh, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi,
           b.v[1].hi);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_q() { return threadIdx.x & 3; }

// A fragment of rows r0.., k k0.. of a row-major tile
__device__ __forceinline__ FragA frag_a(const float* m, int pitch, int r0,
                                        int k0) {
  const float* p = m + (r0 + lane_g()) * pitch + k0 + lane_q();
  return {{split(p[0]), split(p[8 * pitch]), split(p[4]),
           split(p[8 * pitch + 4])}};
}
// B fragment of k k0.., columns n0.. of a tile stored [n][k]
__device__ __forceinline__ FragB frag_b_nk(const float* m, int pitch, int k0,
                                           int n0) {
  const float* p = m + (n0 + lane_g()) * pitch + k0 + lane_q();
  return {{split(p[0]), split(p[4])}};
}
// B fragment of a tile stored [k][n]
__device__ __forceinline__ FragB frag_b_kn(const float* m, int pitch, int k0,
                                           int n0) {
  const float* p = m + (k0 + lane_q()) * pitch + n0 + lane_g();
  return {{split(p[0]), split(p[4 * pitch])}};
}
// B fragment of a tile stored [k][n], rows in the k order of acc_as_a: k q
// is row 2q, k q + 4 row 2q + 1
__device__ __forceinline__ FragB frag_b_perm(const float* m, int pitch,
                                             int k0, int n0) {
  const float* p = m + (k0 + 2 * lane_q()) * pitch + n0 + lane_g();
  return {{split(p[0]), split(p[pitch])}};
}
// an accumulator tile as the A fragment of the product over its columns:
// columns 2q, 2q + 1 taken as k q, q + 4
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return {{split(c[0]), split(c[2]), split(c[1]), split(c[3])}};
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// the sum over the 4 lanes of a fragment row: the same bits on each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// row[col], row[col + 1] = a, b where col (+ 1) < width
__device__ __forceinline__ void store_pair(float* row, int col, int width,
                                           float a, float b) {
  if (col + 1 < width && (reinterpret_cast<uintptr_t>(row + col) & 7) == 0) {
    *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < width) row[col] = a;
    if (col + 1 < width) row[col + 1] = b;
  }
}

// 16 bytes from global to shared memory without passing through registers
// (zeros where !full); cp_async_wait_all waits for the thread's copies
__device__ __forceinline__ void cp_async16(float* dst, const float4* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// rows [0, QC) x columns [0, cols) of a [QC][pitch] tile from a [.][stride]
// array at row step0 (rows past valid, columns past width: 0)
template <int COLS>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          long long step0, long long stride,
                                          int width, int valid, float* dst,
                                          int pitch) {
  const int tid = threadIdx.x;
  staged<QC * COLS / NT>(
      [&](int k) {
        const int i = tid + k * NT, t = i / COLS, j = i % COLS;
        return t < valid && j < width ? __ldg(src + (step0 + t) * stride + j)
                                      : 0.f;
      },
      [&](int k, float v) {
        const int i = tid + k * NT;
        dst[(i / COLS) * pitch + i % COLS] = v;
      });
}

// VEC: P = N = 64 and 16-byte aligned rows, copied as float4 (cp.async)
template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
    ssd_bwd_chain(const float* __restrict__ loga,
                  const float* __restrict__ cmat,
                  const float* __restrict__ dy,
                  const float* __restrict__ state_cot, float* dh,
                  int* ticket, int* done, int bsz, int seq, int nh, int p,
                  int n, int q, int nc) {
  extern __shared__ float smem[];
  float* DY = smem;              // [QC][PC]
  float* CE = DY + QC * PC;      // [QC][NC]  C * exp(csum)
  float* csum = CE + QC * NC;    // [QC]
  __shared__ int s_ticket;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int rows = bsz * nh;
  const int c = nc - 1 - s_ticket / rows, bh = s_ticket % rows;
  const int bb = bh / nh, hh = bh % nh;
  const int c0 = c * q, valid = min(q, seq - c0);
  const long long step0 = (long long)bb * seq + c0;
  // the chunk's dy and C rows and log a: with VEC every copy in flight at
  // once (one wait on memory)
  const float lv = tid < valid ? __ldg(loga + (step0 + tid) * nh + hh)
                               : 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < QC * PC / 4 / NT; ++k) {
      const int i = tid + k * NT, t = i / (PC / 4);
      const long long ay = t < valid
          ? ((step0 + t) * nh * PC + (long long)hh * PC) / 4 + i % (PC / 4)
          : 0;
      const long long ac = t < valid ? (step0 + t) * (NC / 4) + i % (NC / 4)
                                     : 0;
      cp_async16(DY + 4 * i, reinterpret_cast<const float4*>(dy) + ay,
                 t < valid);
      cp_async16(CE + 4 * i, reinterpret_cast<const float4*>(cmat) + ac,
                 t < valid);
    }
    cp_async_wait_all();
  } else {
    load_rows<PC>(dy + (long long)hh * p, step0, (long long)nh * p, p,
                  valid, DY, PC);
    load_rows<NC>(cmat, step0, n, n, valid, CE, NC);
  }
  if (tid < QC) csum[tid] = lv;
  csum_scan(csum);
  const float total = csum[QC - 1];
  __syncthreads();   // total is read: csum takes exp(csum)
  if (tid < QC) csum[tid] = expf(csum[tid]);
  __syncthreads();
  for (int i = tid; i < QC * NC; i += NT) CE[i] *= csum[i / NC];
  __syncthreads();
  // sb[p][n] = sum_t dy_t[p] C_t[n] exp(csum[t]), p = 4ty.., n = 4tx..
  float sb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sb[i][j] = 0.f;
  for (int t = 0; t < valid; ++t) {
    const float4 a = ld4(DY + t * PC + 4 * ty), b4 = ld4(CE + t * NC + 4 * tx);
    const float as[4] = {a.x, a.y, a.z, a.w}, bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sb[i][j] = fmaf(as[i], bs[j], sb[i][j]);
  }
  // dH of this chunk: the final state's cotangent, or the next chunk's
  float g[4][4];
  float* mine = dh + ((long long)bh * nc + c) * PC * NC;
  if (c == nc - 1) {
    const float* sc = state_cot + (long long)bh * p * n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = 4 * ty + i, nn = 4 * tx + j;
        g[i][j] = pp < p && nn < n ? __ldg(sc + pp * n + nn) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      __stcg(reinterpret_cast<float4*>(mine + (4 * ty + i) * NC + 4 * tx),
             make_float4(g[i][0], g[i][1], g[i][2], g[i][3]));
  } else {
    if (tid == 0) {
      while (load_acquire(done + bh) < nc - 1 - c) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldcg(
          reinterpret_cast<const float4*>(mine + (4 * ty + i) * NC + 4 * tx));
      g[i][0] = v.x, g[i][1] = v.y, g[i][2] = v.z, g[i][3] = v.w;
    }
  }
  if (c > 0) {
    const float decay = expf(total);
    float* prev = mine - PC * NC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      __stcg(reinterpret_cast<float4*>(prev + (4 * ty + i) * NC + 4 * tx),
             make_float4(fmaf(decay, g[i][0], sb[i][0]),
                         fmaf(decay, g[i][1], sb[i][1]),
                         fmaf(decay, g[i][2], sb[i][2]),
                         fmaf(decay, g[i][3], sb[i][3])));
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(done + bh, nc - c);
  }
}

// dcs[t] <- sum_{u >= t} dcs[u] over the chunk: warp 0, 4 steps a lane
__device__ __forceinline__ void reverse_cumsum(float* dcs) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float v[4], run = 0.f;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      run += dcs[tid * 4 + j];
      v[j] = run;
    }
    float suf = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (tid + off < 32) suf += o;
    }
    const float after = suf - run;
#pragma unroll
    for (int j = 0; j < 4; ++j) dcs[tid * 4 + j] = v[j] + after;
  }
  __syncthreads();
}

// VEC: P = N = 64 and 16-byte aligned rows, read as float4
template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
    ssd_bwd_chunk(const float* __restrict__ xdt,
                  const float* __restrict__ loga,
                  const float* __restrict__ bmat,
                  const float* __restrict__ cmat,
                  const float* __restrict__ cb,
                  const float* __restrict__ hprev,
                  const float* __restrict__ dh,
                  const float* __restrict__ dy, float* __restrict__ dxdt,
                  float* __restrict__ dloga, float* __restrict__ db_part,
                  float* __restrict__ dc_part, int bsz, int seq, int nh,
                  int p, int n, int q, int nc, int hg) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;               // [QC][XP]  xdt of the head
  float* DY = X + QC * XP;       // [QC][XP]  dy of the head
  float* Bm = DY + QC * XP;      // [QC][XP]  B of the chunk
  float* Cm = Bm + QC * XP;      // [QC][XP]  C of the chunk
  float* HM = Cm + QC * XP;      // [PC][HP]  H_prev of the head
  float* DH = HM + PC * HP;      // [PC][HP]  dH of the head
  float* csum = DH + PC * HP;    // [QC]
  float* ecs = csum + QC;        // [QC]  exp(csum)
  float* dout = ecs + QC;        // [QC]  exp(total - csum)
  float* lcs = dout + QC;        // [QC]  csum log2(e)
  float* dct = lcs + QC;         // [QC]  dcsum's terms of the t rows
  float* dcs = dct + QC;         // [QC]  those of the s rows, then dcsum
  float* es = dcs + QC;          // [QC]  B_s . dB_state_s
  __shared__ float red[NT / 32];

  const int tid = threadIdx.x, warp = tid / 32, g = lane_g(), qd = lane_q();
  const int groups = (nh + hg - 1) / hg;
  const int grp = blockIdx.x % groups, bc = blockIdx.x / groups;
  const int c = bc % nc, bb = bc / nc;
  const int c0 = c * q, valid = min(q, seq - c0);
  const long long step0 = (long long)bb * seq + c0;
  const long long row_stride = (long long)nh * p;
  const float* cbc = cb + ((long long)bb * nc + c) * QC * QC;  // [s][t]
  const int r0 = 16 * warp;                  // the warp's 16 rows
  const int ra = r0 + g, rb = ra + 8;        // the lane's two of them
  const int t_tiles = min(2 * warp + 2, (valid + 7) / 8);
  const int s_tiles = (valid + 7) / 8;

  load_rows<NC>(bmat, step0, n, n, valid, Bm, XP);
  load_rows<NC>(cmat, step0, n, n, valid, Cm, XP);
  // dC (rows ra, rb as t) and dB (as s), over the group's heads
  float dc_acc[NC / 8][4], db_acc[NC / 8][4];
  zero(dc_acc);
  zero(db_acc);

  const int h_end = min(nh, (grp + 1) * hg);
  for (int hh = grp * hg; hh < h_end; ++hh) {
    const long long tile = (((long long)bb * nh + hh) * nc + c) * PC * NC;
    __syncthreads();   // the previous head's reads are done
    // the head's xdt and dy rows, H_prev, dH and log a: with VEC every
    // load in flight before the first store (one wait on memory a head)
    const float lv = tid < valid ? __ldg(loga + (step0 + tid) * nh + hh)
                                 : 0.f;
    float hd = 0.f;    // <dH, H_prev>, for dtotal
    if constexpr (VEC) {
      // straight into shared memory (cp.async: no registers held), then
      // <dH, H_prev> from the thread's own copies
      constexpr int RV = QC * PC / 4 / NT, HV = PC * NC / 4 / NT;
#pragma unroll
      for (int k = 0; k < RV; ++k) {
        const int i = tid + k * NT, t = i / (PC / 4);
        const long long at = t < valid
            ? ((step0 + t) * row_stride + (long long)hh * PC) / 4
                  + i % (PC / 4)
            : 0;
        const int to = t * XP + 4 * (i % (PC / 4));
        cp_async16(X + to, reinterpret_cast<const float4*>(xdt) + at,
                   t < valid);
        cp_async16(DY + to, reinterpret_cast<const float4*>(dy) + at,
                   t < valid);
      }
#pragma unroll
      for (int k = 0; k < HV; ++k) {
        const int i = tid + k * NT;
        const int to = (i / (NC / 4)) * HP + 4 * (i % (NC / 4));
        cp_async16(HM + to, reinterpret_cast<const float4*>(hprev + tile) + i,
                   true);
        cp_async16(DH + to, reinterpret_cast<const float4*>(dh + tile) + i,
                   true);
      }
      cp_async_wait_all();
#pragma unroll
      for (int k = 0; k < HV; ++k) {
        const int i = tid + k * NT;
        const int to = (i / (NC / 4)) * HP + 4 * (i % (NC / 4));
        const float4 a = *reinterpret_cast<const float4*>(HM + to);
        const float4 d = *reinterpret_cast<const float4*>(DH + to);
        hd = fmaf(d.x, a.x, hd);
        hd = fmaf(d.y, a.y, hd);
        hd = fmaf(d.z, a.z, hd);
        hd = fmaf(d.w, a.w, hd);
      }
    } else {
      load_rows<PC>(xdt + (long long)hh * p, step0, row_stride, p, valid, X,
                    XP);
      load_rows<PC>(dy + (long long)hh * p, step0, row_stride, p, valid, DY,
                    XP);
      for (int i = tid; i < PC * NC / 4; i += NT) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(hprev + tile)
                               + i);
        const float4 d = __ldg(reinterpret_cast<const float4*>(dh + tile)
                               + i);
        const int at = (i / (NC / 4)) * HP + 4 * (i % (NC / 4));
        *reinterpret_cast<float4*>(HM + at) = a;
        *reinterpret_cast<float4*>(DH + at) = d;
        hd = fmaf(d.x, a.x, hd);
        hd = fmaf(d.y, a.y, hd);
        hd = fmaf(d.z, a.z, hd);
        hd = fmaf(d.w, a.w, hd);
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      hd += __shfl_xor_sync(0xffffffffu, hd, o);
    if (tid % 32 == 0) red[warp] = hd;
    if (tid < QC) csum[tid] = lv;
    csum_scan(csum);
    const float total = csum[QC - 1];
    if (tid < QC) {
      ecs[tid] = expf(csum[tid]);
      dout[tid] = expf(total - csum[tid]);
      lcs[tid] = csum[tid] * 1.4426950408889634f;
    }
    __syncthreads();

    // -- rows as t: W = L o (dy xdt^T) two tiles of 8 s at a time over
    //    s <= t, dC += W B, then dC's state term exp(csum) dy H_prev
    {
      const float la = lcs[ra], lb = lcs[rb];
      float va = 0.f, vb = 0.f;    // sum_s (C.B)[t][s] W[t][s], then more
      for (int j = 0; j < t_tiles; j += 2) {
        float cbt[2][4];           // C.B at (ra | rb, sa | sb), from L2
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sa = 8 * (j + e) + 2 * qd;
          cbt[e][0] = __ldg(cbc + sa * QC + ra);
          cbt[e][1] = __ldg(cbc + (sa + 1) * QC + ra);
          cbt[e][2] = __ldg(cbc + sa * QC + rb);
          cbt[e][3] = __ldg(cbc + (sa + 1) * QC + rb);
        }
        float ahh[2][4], alh[2][4], ahl[2][4];
        zero(ahh);
        zero(alh);
        zero(ahl);
#pragma unroll
        for (int ks = 0; ks < PC / 8; ++ks) {
          const FragA a = frag_a(DY, XP, r0, 8 * ks);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mma3_apart(ahh[e], alh[e], ahl[e], a,
                       frag_b_nk(X, XP, 8 * ks, 8 * (j + e)));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s0 = 8 * (j + e), sa = s0 + 2 * qd, sb = sa + 1;
          const float lsa = lcs[sa], lsb = lcs[sb];
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = (alh[e][i] + ahl[e][i]) + ahh[e][i];
          w[0] = sa <= ra ? w[0] * fast_exp2(la - lsa) : 0.f;
          w[1] = sb <= ra ? w[1] * fast_exp2(la - lsb) : 0.f;
          w[2] = sa <= rb ? w[2] * fast_exp2(lb - lsa) : 0.f;
          w[3] = sb <= rb ? w[3] * fast_exp2(lb - lsb) : 0.f;
          va = fmaf(cbt[e][0], w[0], fmaf(cbt[e][1], w[1], va));
          vb = fmaf(cbt[e][2], w[2], fmaf(cbt[e][3], w[3], vb));
          const FragA aw = acc_as_a(w);
#pragma unroll
          for (int nt = 0; nt < NC / 8; ++nt)
            mma3(dc_acc[nt], aw, frag_b_perm(Bm, XP, s0, 8 * nt));
        }
      }
      float st[NC / 8][4];
      zero(st);
#pragma unroll
      for (int ks = 0; ks < PC / 8; ++ks) {
        const FragA a = frag_a(DY, XP, r0, 8 * ks);
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
          mma3(st[nt], a, frag_b_kn(HM, HP, 8 * ks, 8 * nt));
      }
      const float ea = ecs[ra], eb = ecs[rb];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
        const int nn = 8 * nt + 2 * qd;
        const float2 ca = *reinterpret_cast<const float2*>(Cm + ra * XP + nn);
        const float2 cv = *reinterpret_cast<const float2*>(Cm + rb * XP + nn);
        st[nt][0] *= ea;
        st[nt][1] *= ea;
        st[nt][2] *= eb;
        st[nt][3] *= eb;
        va = fmaf(ca.x, st[nt][0], fmaf(ca.y, st[nt][1], va));
        vb = fmaf(cv.x, st[nt][2], fmaf(cv.y, st[nt][3], vb));
#pragma unroll
        for (int i = 0; i < 4; ++i) dc_acc[nt][i] += st[nt][i];
      }
      va = quad_sum(va);
      vb = quad_sum(vb);
      if (qd == 0) {
        dct[ra] = va;
        dct[rb] = vb;
      }
    }

    // -- rows as s: dB's state term exp(total - csum) xdt dH, dxdt's
    //    exp(total - csum) B dH^T, then W^T = L^T o (xdt dy^T) two tiles of
    //    8 t at a time over t >= s: dB += W^T C, dxdt += G^T dy
    {
      const float da = dout[ra], dd = dout[rb];
      float ua = 0.f, ub = 0.f;    // B_s . dB_state_s
      {
        float st[NC / 8][4];
        zero(st);
#pragma unroll
        for (int ks = 0; ks < PC / 8; ++ks) {
          const FragA a = frag_a(X, XP, r0, 8 * ks);
#pragma unroll
          for (int nt = 0; nt < NC / 8; ++nt)
            mma3(st[nt], a, frag_b_kn(DH, HP, 8 * ks, 8 * nt));
        }
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt) {
          const int nn = 8 * nt + 2 * qd;
          const float2 ba =
              *reinterpret_cast<const float2*>(Bm + ra * XP + nn);
          const float2 bv =
              *reinterpret_cast<const float2*>(Bm + rb * XP + nn);
          st[nt][0] *= da;
          st[nt][1] *= da;
          st[nt][2] *= dd;
          st[nt][3] *= dd;
          ua = fmaf(ba.x, st[nt][0], fmaf(ba.y, st[nt][1], ua));
          ub = fmaf(bv.x, st[nt][2], fmaf(bv.y, st[nt][3], ub));
#pragma unroll
          for (int i = 0; i < 4; ++i) db_acc[nt][i] += st[nt][i];
        }
      }
      float dx[PC / 8][4];
      zero(dx);
#pragma unroll
      for (int ks = 0; ks < NC / 8; ++ks) {
        const FragA ab = frag_a(Bm, XP, r0, 8 * ks);
#pragma unroll
        for (int pt = 0; pt < PC / 8; ++pt)
          mma3(dx[pt], ab, frag_b_nk(DH, HP, 8 * ks, 8 * pt));
      }
#pragma unroll
      for (int pt = 0; pt < PC / 8; ++pt) {
        dx[pt][0] *= da;
        dx[pt][1] *= da;
        dx[pt][2] *= dd;
        dx[pt][3] *= dd;
      }
      const float la = lcs[ra], lb = lcs[rb];
      float va = 0.f, vb = 0.f;    // sum_t (C.B)[t][s] W[t][s]
      for (int j = 2 * warp; j < s_tiles; j += 2) {
        float2 cbs[2][2];          // C.B at (ra | rb, ta..tb), from L2
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ta = 8 * (j + e) + 2 * qd;
          cbs[e][0] = __ldg(reinterpret_cast<const float2*>(
              cbc + ra * QC + ta));
          cbs[e][1] = __ldg(reinterpret_cast<const float2*>(
              cbc + rb * QC + ta));
        }
        float ahh[2][4], alh[2][4], ahl[2][4];
        zero(ahh);
        zero(alh);
        zero(ahl);
#pragma unroll
        for (int ks = 0; ks < PC / 8; ++ks) {
          const FragA a = frag_a(X, XP, r0, 8 * ks);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mma3_apart(ahh[e], alh[e], ahl[e], a,
                       frag_b_nk(DY, XP, 8 * ks, 8 * (j + e)));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t0 = 8 * (j + e), ta = t0 + 2 * qd, tb = ta + 1;
          const float lta = lcs[ta], ltb = lcs[tb];
          const float l[4] = {ra <= ta ? fast_exp2(lta - la) : 0.f,
                              ra <= tb ? fast_exp2(ltb - la) : 0.f,
                              rb <= ta ? fast_exp2(lta - lb) : 0.f,
                              rb <= tb ? fast_exp2(ltb - lb) : 0.f};
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = ((alh[e][i] + ahl[e][i]) + ahh[e][i]) * l[i];
          const float2 ca = cbs[e][0], cv = cbs[e][1];
          const float gt[4] = {ca.x * l[0], ca.y * l[1], cv.x * l[2],
                               cv.y * l[3]};
          va = fmaf(ca.x, w[0], fmaf(ca.y, w[1], va));
          vb = fmaf(cv.x, w[2], fmaf(cv.y, w[3], vb));
          const FragA aw = acc_as_a(w), ag = acc_as_a(gt);
#pragma unroll
          for (int nt = 0; nt < NC / 8; ++nt)
            mma3(db_acc[nt], aw, frag_b_perm(Cm, XP, t0, 8 * nt));
#pragma unroll
          for (int pt = 0; pt < PC / 8; ++pt)
            mma3(dx[pt], ag, frag_b_perm(DY, XP, t0, 8 * pt));
        }
      }
#pragma unroll
      for (int pt = 0; pt < PC / 8; ++pt) {
        const int pp = 8 * pt + 2 * qd;
        if (ra < valid)
          store_pair(dxdt + (step0 + ra) * row_stride + (long long)hh * p,
                     pp, p, dx[pt][0], dx[pt][1]);
        if (rb < valid)
          store_pair(dxdt + (step0 + rb) * row_stride + (long long)hh * p,
                     pp, p, dx[pt][2], dx[pt][3]);
      }
      va = quad_sum(va + ua);
      vb = quad_sum(vb + ub);
      ua = quad_sum(ua);
      ub = quad_sum(ub);
      if (qd == 0) {
        dcs[ra] = va;
        dcs[rb] = vb;
        es[ra] = ua;
        es[rb] = ub;
      }
    }
    __syncthreads();
    if (tid < QC) dcs[tid] = dct[tid] - dcs[tid];
    __syncthreads();
    // dtotal = exp(total) <dH, H_prev> + sum_s B_s . dB_state_s, at Q - 1
    if (tid < 32) {
      // sum_s es[s] over the valid steps, 4 a lane, then across the warp
      float esum = 0.f;
#pragma unroll
      for (int j = 0; j < QC / 32; ++j)
        esum += 32 * j + tid < valid ? es[32 * j + tid] : 0.f;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        esum += __shfl_xor_sync(0xffffffffu, esum, o);
      if (tid == 0) {
        float hsum = 0.f;
        for (int w = 0; w < NT / 32; ++w) hsum += red[w];
        dcs[QC - 1] += fmaf(expf(total), hsum, esum);
      }
    }
    __syncthreads();
    reverse_cumsum(dcs);
    if (tid < valid) dloga[(step0 + tid) * nh + hh] = dcs[tid];
  }

  // the group's share of dB and dC
  const long long part = ((long long)grp * bsz + bb) * seq + c0;
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt) {
    const int nn = 8 * nt + 2 * qd;
    if (ra < valid) {
      store_pair(dc_part + (part + ra) * n, nn, n, dc_acc[nt][0],
                 dc_acc[nt][1]);
      store_pair(db_part + (part + ra) * n, nn, n, db_acc[nt][0],
                 db_acc[nt][1]);
    }
    if (rb < valid) {
      store_pair(dc_part + (part + rb) * n, nn, n, dc_acc[nt][2],
                 dc_acc[nt][3]);
      store_pair(db_part + (part + rb) * n, nn, n, db_acc[nt][2],
                 db_acc[nt][3]);
    }
  }
}

bool shapes_ok(int chunk, int p, int n) {
  return chunk >= 1 && chunk <= QC && p >= 1 && p <= PC && n >= 1 &&
         n <= NC;
}

// rows of 64 floats on 16-byte boundaries: the float4 paths
bool vec_ok(const void* xdt, const void* b, const void* c, const void* y,
            int p, int n) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return p == PC && n == NC && aligned(xdt) && aligned(b) && aligned(c) &&
         aligned(y);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// b/c [B,S,N] f32, contiguous -> cb [B, nc, 128, 128] f32: C_t . B_s of
// each chunk at [s][t].  chunk <= 128, N <= 64, S >= 1.  Returns the
// launch's cudaError_t.
int ssm_scan_cb(const void* b, const void* c, void* cb, int bsz, int seq,
                int n, int chunk, void* stream) {
  if (!shapes_ok(chunk, 1, n) || seq < 1 || bsz < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nc = (seq + chunk - 1) / chunk;
  ssd_cb<<<dim3(nc, bsz), NT, CB_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(cb), seq, n, chunk, nc);
  return (int)cudaGetLastError();
}

// xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], cb from ssm_scan_cb, all f32
// and contiguous -> y [B,S,H,P] and the final state [B,H,P,N], f32.
// Scratch: hbuf [2, B*H, 64, 64] f32 and counters [B*H + 1] int32 (set to 0
// here, on the stream).  hsave, unless null: [B*H, nc, 64, 64] f32, each
// chunk's incoming state.  chunk <= 128, P <= 64, N <= 64, S >= 1.
// Returns the first cudaError_t of the memset and the launch.
int ssm_scan_chunks(const void* xdt, const void* loga, const void* b,
                    const void* c, const void* cb, void* y, void* state,
                    void* hbuf, void* counters, void* hsave, int bsz,
                    int seq, int nh, int p, int n, int chunk, void* stream) {
  if (!shapes_ok(chunk, p, n) || seq < 1 || bsz < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(xdt, b, c, y, p, n);
  const auto kernel =
      vec ? (hsave ? ssd_chunk<true, true> : ssd_chunk<true, false>)
          : (hsave ? ssd_chunk<false, true> : ssd_chunk<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CHUNK_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = bsz * nh, nc = (seq + chunk - 1) / chunk;
  int* cnt = static_cast<int*>(counters);
  err = cudaMemsetAsync(cnt, 0, sizeof(int) * (rows + 1), st);
  if (err != cudaSuccess) return (int)err;
  // cnt[0] hands out the tickets, cnt[1 + row] counts published chunks
  kernel<<<rows * nc, NT, CHUNK_SMEM, st>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(cb), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(hbuf), cnt, cnt + 1,
      static_cast<float*>(hsave), bsz, seq, nh, p, n, chunk, nc);
  return (int)cudaGetLastError();
}

// The backward's reverse chain.  loga [B,S,H], c [B,S,N], dy [B,S,H,P],
// state_cot [B,H,P,N], f32, contiguous -> dh [B*H, nc, 64, 64] f32: the
// cotangent of the state after each chunk.  Scratch: counters [B*H + 1]
// int32 (set to 0 here).  Returns the first cudaError_t of the memset and
// the launch.
int ssm_scan_bwd_chain(const void* loga, const void* c, const void* dy,
                       const void* state_cot, void* dh, void* counters,
                       int bsz, int seq, int nh, int p, int n, int chunk,
                       void* stream) {
  if (!shapes_ok(chunk, p, n) || seq < 1 || bsz < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = vec_ok(dy, c, c, dy, p, n) ? ssd_bwd_chain<true>
                                                  : ssd_bwd_chain<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_CHAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = bsz * nh, nc = (seq + chunk - 1) / chunk;
  int* cnt = static_cast<int*>(counters);
  err = cudaMemsetAsync(cnt, 0, sizeof(int) * (rows + 1), st);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows * nc, NT, BWD_CHAIN_SMEM, st>>>(
      static_cast<const float*>(loga), static_cast<const float*>(c),
      static_cast<const float*>(dy), static_cast<const float*>(state_cot),
      static_cast<float*>(dh), cnt, cnt + 1, bsz, seq, nh, p, n, chunk, nc);
  return (int)cudaGetLastError();
}

// The backward's chunks.  xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], cb from
// ssm_scan_cb, hprev (ssm_scan_chunks' hsave) and dh (ssm_scan_bwd_chain)
// [B*H, nc, 64, 64], dy [B,S,H,P], all f32 and contiguous -> dxdt
// [B,S,H,P], dloga [B,S,H], and db/dc in one share per group of
// heads_per_block heads, [ceil(H / heads_per_block), B, S, N] (the group's
// heads added in order).  Returns the launch's cudaError_t.
int ssm_scan_bwd_chunks(const void* xdt, const void* loga, const void* b,
                        const void* c, const void* cb, const void* hprev,
                        const void* dh, const void* dy, void* dxdt,
                        void* dloga, void* db_part, void* dc_part, int bsz,
                        int seq, int nh, int p, int n, int chunk,
                        int heads_per_block, void* stream) {
  if (!shapes_ok(chunk, p, n) || seq < 1 || bsz < 1 || nh < 1 ||
      heads_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const auto kernel = vec_ok(xdt, b, c, dy, p, n) ? ssd_bwd_chunk<true>
                                                    : ssd_bwd_chunk<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_CHUNK_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nc = (seq + chunk - 1) / chunk;
  const int groups = (nh + heads_per_block - 1) / heads_per_block;
  kernel<<<bsz * nc * groups, NT, BWD_CHUNK_SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(cb), static_cast<const float*>(hprev),
      static_cast<const float*>(dh), static_cast<const float*>(dy),
      static_cast<float*>(dxdt), static_cast<float*>(dloga),
      static_cast<float*>(db_part), static_cast<float*>(dc_part), bsz, seq,
      nh, p, n, chunk, nc, heads_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
