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

// csum[t] = the inclusive cumsum of log a over the chunk (steps past valid
// add 0): warp 0, 4 steps a lane
__device__ __forceinline__ void chunk_csum(const float* __restrict__ loga,
                                           long long step0, int nh, int hh,
                                           int valid, float* csum) {
  const int tid = threadIdx.x;
  if (tid < QC)
    csum[tid] = tid < valid ? __ldg(loga + (step0 + tid) * nh + hh) : 0.f;
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
// The backward.  Per chunk, with dy the cotangent of y, dH that of the state
// after the chunk, L[t][s] = exp(csum[t] - csum[s]) for s <= t (else 0),
// DX[t][s] = dy_t . xdt_s and W = L o DX:
//   dH_prev  = exp(total) dH + sum_t exp(csum[t]) dy_t (x) C_t
//   dxdt_s   = sum_t (C_t . B_s) L[t][s] dy_t + exp(total - csum[s]) dH B_s
//   dC_t     = sum_s W[t][s] B_s + exp(csum[t]) dy_t H_prev
//   dB_s     = sum_t W[t][s] C_t + exp(total - csum[s]) xdt_s dH
//   dcsum[t] = sum_s (C.B)[t][s] W[t][s] - sum_u (C.B)[u][t] W[u][t]
//            + C_t . (exp(csum[t]) dy_t H_prev)
//            - B_t . (exp(total - csum[t]) xdt_t dH)
//            + [t = Q-1] sum(dH o H_new)
//   dloga    = the reverse cumsum of dcsum within the chunk
// dB and dC are summed over the heads of a batch row by the caller, from
// one share a head (no atomics: the same bits on every run).
//
// ssd_bwd_chain  the reverse chain: one block per (batch, head, chunk),
//                tickets handed out from the last chunk down (so every
//                chunk's successor started first).  A block forms its
//                chunk's sum_t exp(csum[t]) dy_t (x) C_t on its own, waits
//                for the chunk after it to publish dH, writes dH_prev for
//                the chunk before it and releases the row's counter.  dh
//                [B*H][nc][64][64] ends holding every chunk's dH, the last
//                one the final state's cotangent.
// ssd_bwd_chunk  one block per (batch, head, chunk), no order among them:
//                the chunk's tiles in shared memory (xdt, dy, B, C at pitch
//                68, one [Q][Q] tile at pitch 132, H_prev then dH), 256
//                threads each owning rows r = ty + 16 i and columns
//                c = tx + 16 j of a product, so a warp's reads of a row
//                tile are broadcasts and of a column tile consecutive.  The
//                tile holds W, then G = (C.B) o L.  Plain f32 on the CUDA
//                cores, as the forward; exp(csum[t] - csum[s]) for s <= t
//                only.

constexpr int PP = PC + 4;    // pitch of the [.][P or N] tiles
constexpr size_t BWD_CHAIN_SMEM = sizeof(float) * (2 * QC * PC + QC);
constexpr size_t BWD_CHUNK_SMEM =
    sizeof(float) * (4 * (size_t)QC * PP + (size_t)QC * TP + PC * PP +
                     6 * QC);

__device__ __forceinline__ float warp_sum16(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  load_rows<PC>(dy + (long long)hh * p, step0, (long long)nh * p, p, valid,
                DY, PC);
  load_rows<NC>(cmat, step0, n, n, valid, CE, NC);
  chunk_csum(loga, step0, nh, hh, valid, csum);
  const float total = csum[QC - 1];
  for (int i = tid; i < QC * NC; i += NT) CE[i] *= expf(csum[i / NC]);
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

// out[r][c] (r = ty + 16 i, i < 8; c = tx + 16 j, j < J) += sum_k a(r, k)
// b(k, c) over k < kn
template <int J, class A, class B>
__device__ __forceinline__ void product(float (&acc)[8][J], int kn, A a,
                                        B b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < kn; ++k) {
    float av[8], bv[J];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = a(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[8][J]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

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
                  int p, int n, int q, int nc) {
  extern __shared__ float smem[];
  float* X = smem;               // [QC][PP]  xdt
  float* DY = X + QC * PP;       // [QC][PP]  dy
  float* Bm = DY + QC * PP;      // [QC][PP]  B
  float* Cm = Bm + QC * PP;      // [QC][PP]  C
  float* T = Cm + QC * PP;       // [QC][TP]  W, later G, at [t][s]
  float* HM = T + QC * TP;       // [PC][PP]  H_prev, later dH
  float* csum = HM + PC * PP;    // [QC]
  float* ecs = csum + QC;        // [QC]  exp(csum)
  float* dout = ecs + QC;        // [QC]  exp(total - csum)
  float* lcs = dout + QC;        // [QC]  csum log2(e)
  float* dcs = lcs + QC;         // [QC]  dcsum, then dloga
  float* es = dcs + QC;          // [QC]  B_s . dB_state_s
  __shared__ float red[NT / 32];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int bb = bh / nh, hh = bh % nh;
  const int c0 = c * q, valid = min(q, seq - c0);
  const long long step0 = (long long)bb * seq + c0;
  const long long row_stride = (long long)nh * p;
  const float* hp_g = hprev + ((long long)bh * nc + c) * PC * NC;
  const float* dh_g = dh + ((long long)bh * nc + c) * PC * NC;
  const float* cbc = cb + ((long long)bb * nc + c) * QC * QC;  // [s][t]

  load_rows<PC>(xdt + (long long)hh * p, step0, row_stride, p, valid, X, PP);
  load_rows<PC>(dy + (long long)hh * p, step0, row_stride, p, valid, DY, PP);
  load_rows<NC>(bmat, step0, n, n, valid, Bm, PP);
  load_rows<NC>(cmat, step0, n, n, valid, Cm, PP);
  for (int i = tid; i < PC * NC; i += NT)
    HM[(i / NC) * PP + i % NC] = __ldcg(hp_g + i);
  // <dH, H_prev>, for dtotal
  float hd = 0.f;
  for (int i = tid; i < PC * NC; i += NT)
    hd = fmaf(__ldcg(dh_g + i), __ldcg(hp_g + i), hd);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
  if (tid % 32 == 0) red[tid / 32] = hd;
  chunk_csum(loga, step0, nh, hh, valid, csum);   // syncs
  const float total = csum[QC - 1];
  if (tid < QC) {
    ecs[tid] = expf(csum[tid]);
    dout[tid] = expf(total - csum[tid]);
    lcs[tid] = csum[tid] * 1.4426950408889634f;
    dcs[tid] = 0.f;
  }
  __syncthreads();

  // W[t][s] = L[t][s] dy_t . xdt_s
  {
    float acc[8][8];
    zero(acc);
    product(acc, p, [&](int t, int k) { return DY[t * PP + k]; },
            [&](int k, int s) { return X[s * PP + k]; });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        T[t * TP + s] = s <= t ? acc[i][j] * fast_exp2(lcs[t] - lcs[s]) : 0.f;
      }
  }
  __syncthreads();
  // the intra gate's share of dcsum: row sums minus column sums of
  // (C.B) o W, each in one thread's fixed order
  float colsum = 0.f;
  if (tid < QC) {
    float row = 0.f;
    for (int s = 0; s <= tid; ++s)
      row = fmaf(__ldg(cbc + s * QC + tid), T[tid * TP + s], row);
    dcs[tid] = row;
  } else {
    const int s = tid - QC;
    for (int t = s; t < QC; ++t)
      colsum = fmaf(__ldg(cbc + s * QC + t), T[t * TP + s], colsum);
  }
  __syncthreads();
  if (tid >= QC) dcs[tid - QC] -= colsum;

  // dC = W B + exp(csum) dy H_prev; dcsum += C . (the second term)
  {
    float acc[8][4], inter[8][4];
    zero(acc);
    zero(inter);
    product(acc, valid, [&](int t, int s) { return T[t * TP + s]; },
            [&](int s, int nn) { return Bm[s * PP + nn]; });
    product(inter, p, [&](int t, int k) { return DY[t * PP + k]; },
            [&](int k, int nn) { return HM[k * PP + nn]; });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = tx + 16 * j;
        inter[i][j] *= ecs[t];
        part = fmaf(Cm[t * PP + nn], inter[i][j], part);
        if (t < valid && nn < n)
          dc_part[(((long long)hh * bsz + bb) * seq + c0 + t) * n + nn] =
              acc[i][j] + inter[i][j];
      }
      part = warp_sum16(part);
      __syncwarp();
      if (tx == 0) dcs[t] += part;
    }
  }
  __syncthreads();   // H_prev is read: HM takes dH
  for (int i = tid; i < PC * NC; i += NT)
    HM[(i / NC) * PP + i % NC] = __ldcg(dh_g + i);
  __syncthreads();

  // dB = W^T C + exp(total - csum) xdt dH; dcsum -= B . (the second term)
  {
    float acc[8][4], st[8][4];
    zero(acc);
    zero(st);
    product(acc, valid, [&](int s, int t) { return T[t * TP + s]; },
            [&](int t, int nn) { return Cm[t * PP + nn]; });
    product(st, p, [&](int s, int k) { return X[s * PP + k]; },
            [&](int k, int nn) { return HM[k * PP + nn]; });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = tx + 16 * j;
        st[i][j] *= dout[s];
        part = fmaf(Bm[s * PP + nn], st[i][j], part);
        if (s < valid && nn < n)
          db_part[(((long long)hh * bsz + bb) * seq + c0 + s) * n + nn] =
              acc[i][j] + st[i][j];
      }
      part = warp_sum16(part);
      __syncwarp();
      if (tx == 0) {
        dcs[s] -= part;
        es[s] = part;
      }
    }
  }
  __syncthreads();   // W is read: T takes G

  // G[t][s] = (C_t . B_s) L[t][s]
  staged<QC * QC / NT>(
      [&](int k) {
        const int i = tid + k * NT, s = i / QC, t = i % QC;
        return s <= t ? __ldg(cbc + i) : 0.f;
      },
      [&](int k, float v) {
        const int i = tid + k * NT, s = i / QC, t = i % QC;
        T[t * TP + s] = s <= t ? v * fast_exp2(lcs[t] - lcs[s]) : 0.f;
      });
  __syncthreads();

  // dxdt = G^T dy + exp(total - csum) B dH^T
  {
    float acc[8][4], st[8][4];
    zero(acc);
    zero(st);
    product(acc, valid, [&](int s, int t) { return T[t * TP + s]; },
            [&](int t, int pp) { return DY[t * PP + pp]; });
    product(st, n, [&](int s, int k) { return Bm[s * PP + k]; },
            [&](int k, int pp) { return HM[pp * PP + k]; });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
      if (s >= valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = tx + 16 * j;
        if (pp < p)
          dxdt[(step0 + s) * row_stride + (long long)hh * p + pp] =
              fmaf(dout[s], st[i][j], acc[i][j]);
      }
    }
  }

  // dtotal = exp(total) <dH, H_prev> + sum_s B_s . dB_state_s, at Q - 1
  if (tid == 0) {
    float hsum = 0.f, esum = 0.f;
    for (int w = 0; w < NT / 32; ++w) hsum += red[w];
    for (int s = 0; s < valid; ++s) esum += es[s];
    dcs[QC - 1] += fmaf(expf(total), hsum, esum);
  }
  __syncthreads();
  reverse_cumsum(dcs);
  if (tid < valid) dloga[(step0 + tid) * nh + hh] = dcs[tid];
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
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_CHAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = bsz * nh, nc = (seq + chunk - 1) / chunk;
  int* cnt = static_cast<int*>(counters);
  err = cudaMemsetAsync(cnt, 0, sizeof(int) * (rows + 1), st);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chain<<<rows * nc, NT, BWD_CHAIN_SMEM, st>>>(
      static_cast<const float*>(loga), static_cast<const float*>(c),
      static_cast<const float*>(dy), static_cast<const float*>(state_cot),
      static_cast<float*>(dh), cnt, cnt + 1, bsz, seq, nh, p, n, chunk, nc);
  return (int)cudaGetLastError();
}

// The backward's chunks.  xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], cb from
// ssm_scan_cb, hprev (ssm_scan_chunks' hsave) and dh (ssm_scan_bwd_chain)
// [B*H, nc, 64, 64], dy [B,S,H,P], all f32 and contiguous -> dxdt
// [B,S,H,P], dloga [B,S,H], and each head's share of db and dc
// [H,B,S,N].  Returns the launch's cudaError_t.
int ssm_scan_bwd_chunks(const void* xdt, const void* loga, const void* b,
                        const void* c, const void* cb, const void* hprev,
                        const void* dh, const void* dy, void* dxdt,
                        void* dloga, void* db_part, void* dc_part, int bsz,
                        int seq, int nh, int p, int n, int chunk,
                        void* stream) {
  if (!shapes_ok(chunk, p, n) || seq < 1 || bsz < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_CHUNK_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = bsz * nh, nc = (seq + chunk - 1) / chunk;
  ssd_bwd_chunk<<<rows * nc, NT, BWD_CHUNK_SMEM,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(cb), static_cast<const float*>(hprev),
      static_cast<const float*>(dh), static_cast<const float*>(dy),
      static_cast<float*>(dxdt), static_cast<float*>(dloga),
      static_cast<float*>(db_part), static_cast<float*>(dc_part), bsz, seq,
      nh, p, n, chunk, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
