// Flash-attention backward: dq, dk and dv of flash_attention.cu's forward
// from the saved q, k, v, out, the rows' log-sum-exp and the output's
// cotangent dO, with the forward's masks (causal, top-left aligned; sliding
// window; keys at or past valid_len), GQA, and v at its own head dim Dv <= D
// (MLA's 128 beside q/k's 192), in the model layout [B, S, H, D].
//
// Replaces: the backward of the reference's flash attention, _flash_bwd in
// src/repro/models/attention.py (the jax.custom_vjp of flash_attention, whose
// forward is the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py, flash_attention_kernel).  It recomputes the probabilities
// block by block from the saved log-sum-exp, "exactly what the Pallas TPU
// kernel does on-chip"; XLA runs it as einsums over 512-key blocks.
//
// What bounds it on the H100: operations.  Five products of the pairs the
// masks leave (q·kᵀ and dO·vᵀ recomputed, dv, dk and dq: 2 (3 D + 2 Dv)
// operations a pair, kernels/work.py, flash_bwd_work) against q, k, v, out,
// dO and lse read and dq, dk, dv written once; bf16, causal, S = 2048:
//   qwen3-1.7b      B 4, H 16/8, D 128   34.4 GFLOP / 0.10 GB  0.035 ms
//   starcoder2-7b   B 4, H 36/4, D 128   77.4 GFLOP / 0.19 GB  0.078 ms
// (operations over 989 TFLOP/s; bytes over 3.35 TB/s about a third of
// that).  The products run on the tensor cores.
//
// Three passes, all in fixed orders (no atomics: the same bits every run):
// - flash_bwd_delta: delta = rowsum(out * dO) in f32, [B, Hq, Sq], a warp
//   a row.
// - dkdv: one CTA per (key tile, kv head, batch row).  It walks the G query
//   heads of its group and, for each, the query tiles that the masks leave
//   live for its keys (query_rows); for each tile it recomputes
//   S = q·kᵀ, P = exp(S * scale - lse) (0 where masked), dP = dO·vᵀ and
//   dS = P (dP - delta) scale, and adds dv += Pᵀ·dO and dk += dSᵀ·q into
//   accumulators that stay in registers and are written once.  The group's
//   sum happens in the CTA, and each K/V tile is read once for the group.
// - dq: one CTA per (query tile, q head, batch row), walking the live key
//   tiles (key_cols) and adding dq += dS·k in registers, written once.
// A pass of its own for dq (FlashAttention-2 adds it with f32 atomics)
// costs two recomputed products, seven where five would do, for bits that
// do not depend on the order the CTAs run in.
//
// Two routes, one function; the dispatch looks at dtype, head dims and
// alignment only, as the forward's does:
// - bf16 with (D, Dv) in {(64, 64), (96, 96), (128, 128), (192, 128),
//   (256, 256)}, bases 16-byte aligned and strides multiples of 8 elements:
//   flash_bwd_dkdv_mma / flash_bwd_dq_mma<D, Dv>, mma.sync.m16n8k16 in bf16
//   with f32 accumulation.  A CTA is an outer tile of BO rows (keys for
//   dkdv, queries for dq), BO / 16 row blocks of 16 by 2 column halves, a
//   warp each: BO = 32 (4 warps, two CTAs an SM) up to D 128, 64 (8 warps)
//   at D 192 and 256.  Inner tiles of 64 rows arrive by cp.async (16-byte
//   copies, zero-filled past S: no padded copy of any input), double
//   buffered so the next tile's copies overlap this one's products.
//   Phase A: warp (m, n) forms its 16 x 32 block of S and dP (operands by
//   ldmatrix from shared memory, rows padded by 16 bytes so the reads are
//   free of bank conflicts), applies the mask and the softmax gradient in
//   f32 and stores P and dS rounded to bf16 in shared memory.  Phase B: warp (m, n) adds
//   its 16 rows x (D / 2) columns of dk and (Dv / 2) of dv (or of dq) from
//   those tiles, the inner operand read transposed (ldmatrix .trans).  At
//   D 256 that is 128 f32 accumulators a thread (dk and dv), the largest
//   case; shared memory 217 KB (dkdv) and 208 KB (dq); at D 128 95 and
//   90 KB.  (Tilings measured at qwen3-1.7b's B 4, S 2048 on the H100: BO
//   32 1.69 ms, 64 1.76, 128 with a warp a row block 1.62 but spilling at
//   D 192 and 256; inner tiles of 32 rows 2.08.  At B 8, S 128 BO 32 gains
//   15% at the group of 9 and loses 12% at D 192.  No tiling moved it far:
//   the time goes to mma.sync's fragment loads and their latency.)
// - Everything else (f32; bf16 at other head dims up to 256, or unaligned
//   rows): flash_bwd_dkdv / flash_bwd_dq<T, DMAX>, the same two passes in
//   f32 on the CUDA cores, 32-row tiles, 256 threads (8 row groups x 32
//   lanes), built for head dims up to 64, 128 and 256 (137 KB of shared
//   memory there).
// Rows with no live key (a window past valid_len) have lse -1e30: their P
// is set to 0 by the mask, never formed as exp(s + 1e30).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int hq, group, sq, sk, d, dv, kv_lim, causal, window;
  float scale;
};

// (batch, seq, head) element strides of q, k, v, out, dO, dq, dk, dv
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// (row, col) is live: a real query row, a key below min(sk, valid_len), at
// or before the row when causal, inside the row's window.
__device__ __forceinline__ bool live(int row, int col, const Shape& s) {
  return row < s.sq && col < s.kv_lim && (!s.causal || col <= row) &&
         (s.window <= 0 || row - col < s.window);
}

// The query rows [lo, hi) that see a key of [k0, k0 + n): from k0 on when
// causal, below the window's reach past the last live key.
__device__ __forceinline__ int2 query_rows(int k0, int n, const Shape& s) {
  const int k1 = min(k0 + n, s.kv_lim);
  const int lo = s.causal ? k0 : 0;
  if (k1 <= k0) return make_int2(lo, lo);
  const int hi = s.window > 0 ? min(s.sq, k1 - 1 + s.window) : s.sq;
  return make_int2(lo, max(lo, hi));
}

// The keys [lo, hi) that rows [q0, q0 + n) see: below min(sk, valid_len)
// and, when causal, at or before the last row; inside the first row's
// window.
__device__ __forceinline__ int2 key_cols(int q0, int n, const Shape& s) {
  const int q1 = min(q0 + n, s.sq);
  const int hi = s.causal ? min(s.kv_lim, q1) : s.kv_lim;
  const int lo = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  return make_int2(lo, max(lo, hi));
}

// ---------------------------------------------------------------------------
// delta = rowsum(out * dO), f32 [B, Hq, Sq]: a warp a row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
                    float* __restrict__ delta, int b, Shape s, Strides st) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)b * s.hq * s.sq) return;
  const int i = (int)(row % s.sq);
  const int h = (int)((row / s.sq) % s.hq);
  const int bb = (int)(row / ((long long)s.sq * s.hq));
  const T* op = o + bb * st.o[0] + i * st.o[1] + h * st.o[2];
  const T* gp = g + bb * st.g[0] + i * st.g[1] + h * st.g[2];
  float acc = 0.f;
  for (int c = lane; c < s.dv; c += 32)
    acc = fmaf(to_f32(op[c]), to_f32(gp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, operands by ldmatrix
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// acc[NB] (16 rows x 8 NB columns) += A · Bᵀ over K: A's 16 rows at a, B's
// 8 NB rows at b, both stored row by row (K contiguous) in shared memory
// with row strides lda and ldb.  Lane l addresses row l % 16 of A (k half
// l / 16) and row (l / 16) 8 + l % 8 of a pair of B's n blocks (k half
// (l / 8) % 2): the four 8x8 matrices are a0..a3 and b0, b1 of two blocks.
template <int K, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        int lane) {
  static_assert(K % 16 == 0 && NB % 2 == 0, "K and NB");
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + kk + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (j * 8 + (lane / 16) * 8 + lane % 8) * ldb + kk +
                      ((lane / 8) % 2) * 8);
      mma16816(acc[j], af, bf[0], bf[1]);
      mma16816(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[NB] += A · B over K: A as in mma_abt, B stored by its K rows (row
// stride ldb, its 8 NB columns contiguous), read transposed: lane l
// addresses B's row kk + l % 16 at column block (l / 16).
template <int K, int NB>
__device__ __forceinline__ void mma_ab(float (&acc)[NB][4], const bf16* a,
                                       int lda, const bf16* b, int ldb,
                                       int lane) {
  static_assert(K % 16 == 0 && NB % 2 == 0, "K and NB");
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + kk + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk + lane % 16) * ldb + j * 8 + (lane / 16) * 8);
      mma16816(acc[j], af, bf[0], bf[1]);
      mma16816(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// 16 bytes from global to shared memory, zero-filled when !full (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of COLS bf16 each, the row r at src + r * rs,
// into dst with row stride LD; rows at or past `limit` zero-filled.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int row0, int limit,
                                          int tid) {
  constexpr int CH = COLS / 8;
#pragma unroll 4
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool full = row0 + r < limit;
    cp_async16(dst + r * LD + c * 8,
               full ? src + (long long)(row0 + r) * rs + c * 8 : src, full);
  }
}

__device__ __forceinline__ void st32(bf16* p, uint32_t x) {
  *reinterpret_cast<uint32_t*>(p) = x;
}

// A warp's accumulators (rows row0 + g, + 8; columns col0 + 8 j + 2 t, + 1)
// rounded to bf16 into dst (rows rs apart), rows at or past limit left out.
template <int NB>
__device__ __forceinline__ void store_acc(bf16* dst, long long rs, int row0,
                                          int limit, int col0,
                                          const float (&acc)[NB][4],
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      st32(dst + row * rs + col0 + 8 * j + 2 * t,
           pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]));
  }
}

template <int D, int DV>
struct Mma {
  // outer rows: keys (dkdv), queries (dq); 32 (4 warps, two CTAs an SM)
  // up to D 128, 64 (8 warps, one CTA an SM) at D 192 and 256
  static constexpr int BO = D <= 128 ? 32 : 64;
  static constexpr int BI = 64;   // inner rows a tile
  static constexpr int WN = 2;    // warps across the columns
  static constexpr int WM = BO / 16;
  static constexpr int THREADS = 32 * WM * WN;
  // padded row lengths (bf16): 16 bytes more, so that the 8 rows an
  // ldmatrix reads fall in 8 different 16-byte bank groups
  static constexpr int LD = D + 8, LDV = DV + 8, LDP = BI + 8;
  static constexpr int NA = BI / WN / 8;           // phase A blocks a warp
  static constexpr int NK = D / WN / 8, NV = DV / WN / 8;  // phase B
  static_assert(D % 32 == 0 && DV % 32 == 0 && DV <= D, "head dims");
  // dkdv: K and V; two stages of (q, dO); Pᵀ and dSᵀ; two of (lse, delta)
  static constexpr size_t DKDV_BYTES =
      2 * ((size_t)BO * (LD + LDV) + 2 * (size_t)BI * (LD + LDV) +
           2 * (size_t)BO * LDP) +
      4 * 4 * BI;
  // dq: q and dO; two stages of (K, V); dS; lse and delta of the rows
  static constexpr size_t DQ_BYTES =
      2 * ((size_t)BO * (LD + LDV) + 2 * (size_t)BI * (LD + LDV) +
           (size_t)BO * LDP) +
      2 * 4 * BO;
};

template <int D, int DV>
__global__ void __launch_bounds__(Mma<D, DV>::THREADS, 1)
    flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, Shape s, Strides st) {
  using C = Mma<D, DV>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ko = reinterpret_cast<bf16*>(smem);   // [BO][LD]
  bf16* Vo = Ko + C::BO * C::LD;              // [BO][LDV]
  bf16* Qi = Vo + C::BO * C::LDV;             // [2][BI][LD]
  bf16* Gi = Qi + 2 * C::BI * C::LD;          // [2][BI][LDV]  dO
  bf16* Pt = Gi + 2 * C::BI * C::LDV;         // [BO][LDP]  Pᵀ
  bf16* St = Pt + C::BO * C::LDP;             // [BO][LDP]  dSᵀ
  float* Li = reinterpret_cast<float*>(St + C::BO * C::LDP);  // [2][BI]
  float* Di = Li + 2 * C::BI;                                 // [2][BI]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int gr = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * C::BO, hk = blockIdx.y, bb = blockIdx.z;

  load_rows<C::BO, D, C::LD, C::THREADS>(
      Ko, k + bb * st.k[0] + hk * st.k[2], st.k[1], k0, s.sk, tid);
  load_rows<C::BO, DV, C::LDV, C::THREADS>(
      Vo, v + bb * st.v[0] + hk * st.v[2], st.v[1], k0, s.sk, tid);
  cp_async_commit();

  const int2 rows = query_rows(k0, C::BO, s);
  const int tiles = (rows.y - rows.x + C::BI - 1) / C::BI;
  const int steps = tiles * s.group;

  // step it: query head hk * group + it / tiles, rows from q0_of(it)
  auto q0_of = [&](int it) { return rows.x + (it % tiles) * C::BI; };
  auto fetch = [&](int it) {
    const int buf = it & 1, h = hk * s.group + it / tiles, q0 = q0_of(it);
    load_rows<C::BI, D, C::LD, C::THREADS>(
        Qi + buf * C::BI * C::LD, q + bb * st.q[0] + h * st.q[2], st.q[1],
        q0, s.sq, tid);
    load_rows<C::BI, DV, C::LDV, C::THREADS>(
        Gi + buf * C::BI * C::LDV, g + bb * st.g[0] + h * st.g[2], st.g[1],
        q0, s.sq, tid);
    const long long base = ((long long)bb * s.hq + h) * s.sq + q0;
    for (int i = tid; i < C::BI; i += C::THREADS) {
      const bool in = q0 + i < s.sq;
      Li[buf * C::BI + i] = in ? lse[base + i] * LOG2E : 0.f;
      Di[buf * C::BI + i] = in ? delta[base + i] : 0.f;
    }
    cp_async_commit();
  };

  float acc_k[C::NK][4] = {}, acc_v[C::NV][4] = {};
  const float scale_log2 = s.scale * LOG2E;
  if (steps > 0) fetch(0);
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1, q0 = q0_of(it);
    if (it + 1 < steps) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qi + buf * C::BI * C::LD;
    const bf16* Gb = Gi + buf * C::BI * C::LDV;
    {
      // phase A: this warp's 16 keys x BI / WN queries of Sᵀ and dPᵀ
      float sa[C::NA][4] = {}, pa[C::NA][4] = {};
      const int c0 = wn * (C::BI / C::WN);
      mma_abt<D, C::NA>(sa, Ko + 16 * wm * C::LD, C::LD, Qb + c0 * C::LD,
                        C::LD, lane);
      mma_abt<DV, C::NA>(pa, Vo + 16 * wm * C::LDV, C::LDV,
                         Gb + c0 * C::LDV, C::LDV, lane);
      const float* L = Li + buf * C::BI;
      const float* Dl = Di + buf * C::BI;
#pragma unroll
      for (int j = 0; j < C::NA; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * wm + gr + 8 * hh, c = c0 + 8 * j + 2 * t;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = live(q0 + c + e, k0 + r, s)
                       ? exp2f(fmaf(sa[j][2 * hh + e], scale_log2, -L[c + e]))
                       : 0.f;
            ds[e] = p[e] * (pa[j][2 * hh + e] - Dl[c + e]) * s.scale;
          }
          st32(Pt + r * C::LDP + c, pack_bf16(p[0], p[1]));
          st32(St + r * C::LDP + c, pack_bf16(ds[0], ds[1]));
        }
    }
    __syncthreads();
    // phase B: dv += Pᵀ·dO and dk += dSᵀ·q over this warp's columns
    mma_ab<C::BI, C::NV>(acc_v, Pt + 16 * wm * C::LDP, C::LDP,
                         Gb + wn * (DV / C::WN), C::LDV, lane);
    mma_ab<C::BI, C::NK>(acc_k, St + 16 * wm * C::LDP, C::LDP,
                         Qb + wn * (D / C::WN), C::LD, lane);
    __syncthreads();
  }
  cp_async_wait<0>();  // K and V's copies, when no step waited for them
  const int row0 = k0 + 16 * wm;
  store_acc<C::NK>(dk + bb * st.dk[0] + hk * st.dk[2], st.dk[1], row0, s.sk,
                   wn * (D / C::WN), acc_k, lane);
  store_acc<C::NV>(dv + bb * st.dv[0] + hk * st.dv[2], st.dv[1], row0, s.sk,
                   wn * (DV / C::WN), acc_v, lane);
}

template <int D, int DV>
__global__ void __launch_bounds__(Mma<D, DV>::THREADS, 1)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     Shape s, Strides st) {
  using C = Mma<D, DV>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qo = reinterpret_cast<bf16*>(smem);   // [BO][LD]
  bf16* Go = Qo + C::BO * C::LD;              // [BO][LDV]  dO
  bf16* Ki = Go + C::BO * C::LDV;             // [2][BI][LD]
  bf16* Vi = Ki + 2 * C::BI * C::LD;          // [2][BI][LDV]
  bf16* Sd = Vi + 2 * C::BI * C::LDV;         // [BO][LDP]  dS
  float* Lo = reinterpret_cast<float*>(Sd + C::BO * C::LDP);  // [BO]
  float* Do = Lo + C::BO;                                     // [BO]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * C::BO, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / s.group;

  load_rows<C::BO, D, C::LD, C::THREADS>(
      Qo, q + bb * st.q[0] + h * st.q[2], st.q[1], q0, s.sq, tid);
  load_rows<C::BO, DV, C::LDV, C::THREADS>(
      Go, g + bb * st.g[0] + h * st.g[2], st.g[1], q0, s.sq, tid);
  cp_async_commit();
  const long long base = ((long long)bb * s.hq + h) * s.sq + q0;
  for (int i = tid; i < C::BO; i += C::THREADS) {
    const bool in = q0 + i < s.sq;
    Lo[i] = in ? lse[base + i] * LOG2E : 0.f;
    Do[i] = in ? delta[base + i] : 0.f;
  }

  const int2 cols = key_cols(q0, C::BO, s);
  const int steps = (cols.y - cols.x + C::BI - 1) / C::BI;
  const bf16* kb = k + bb * st.k[0] + hk * st.k[2];
  const bf16* vb = v + bb * st.v[0] + hk * st.v[2];
  auto fetch = [&](int it) {
    const int buf = it & 1, k0 = cols.x + it * C::BI;
    load_rows<C::BI, D, C::LD, C::THREADS>(Ki + buf * C::BI * C::LD, kb,
                                           st.k[1], k0, s.sk, tid);
    load_rows<C::BI, DV, C::LDV, C::THREADS>(Vi + buf * C::BI * C::LDV, vb,
                                             st.v[1], k0, s.sk, tid);
    cp_async_commit();
  };

  float acc_q[C::NK][4] = {};
  const float scale_log2 = s.scale * LOG2E;
  if (steps > 0) fetch(0);
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1, k0 = cols.x + it * C::BI;
    if (it + 1 < steps) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ki + buf * C::BI * C::LD;
    const bf16* Vb = Vi + buf * C::BI * C::LDV;
    {
      // phase A: this warp's 16 queries x BI / WN keys of S and dP
      float sa[C::NA][4] = {}, pa[C::NA][4] = {};
      const int c0 = wn * (C::BI / C::WN);
      mma_abt<D, C::NA>(sa, Qo + 16 * wm * C::LD, C::LD, Kb + c0 * C::LD,
                        C::LD, lane);
      mma_abt<DV, C::NA>(pa, Go + 16 * wm * C::LDV, C::LDV,
                         Vb + c0 * C::LDV, C::LDV, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * wm + gr + 8 * hh;
        const float lr = Lo[r], dr = Do[r];
#pragma unroll
        for (int j = 0; j < C::NA; ++j) {
          const int c = c0 + 8 * j + 2 * t;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                live(q0 + r, k0 + c + e, s)
                    ? exp2f(fmaf(sa[j][2 * hh + e], scale_log2, -lr))
                    : 0.f;
            ds[e] = p * (pa[j][2 * hh + e] - dr) * s.scale;
          }
          st32(Sd + r * C::LDP + c, pack_bf16(ds[0], ds[1]));
        }
      }
    }
    __syncthreads();
    // phase B: dq += dS·k over this warp's columns
    mma_ab<C::BI, C::NK>(acc_q, Sd + 16 * wm * C::LDP, C::LDP,
                         Kb + wn * (D / C::WN), C::LD, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc<C::NK>(dq + bb * st.dq[0] + h * st.dq[2], st.dq[1], q0 + 16 * wm,
                   s.sq, wn * (D / C::WN), acc_q, lane);
}

// ---------------------------------------------------------------------------
// f32 and other head dims: the CUDA cores
// ---------------------------------------------------------------------------
constexpr int CB = 32;   // rows a tile, outer and inner
constexpr int CT = 256;  // threads: 8 row groups x 32 lanes
constexpr int CR = CB / 8;  // outer rows a thread

template <int DMAX>
constexpr size_t cc_bytes() {
  return sizeof(float) * (4 * (size_t)CB * (DMAX + 1) +
                          2 * (size_t)CB * (CB + 1) + 2 * CB);
}

// rows [row0, row0 + CB) of `cols` values (row r at src + r * rs) as f32
// into dst [CB][DMAX + 1]; zeros past `limit` and past `cols`.
template <typename T, int DMAX>
__device__ __forceinline__ void load_f32(float* dst, const T* src,
                                         long long rs, int row0, int limit,
                                         int cols, int tid) {
  for (int i = tid; i < CB * DMAX; i += CT) {
    const int r = i / DMAX, c = i % DMAX;
    dst[r * (DMAX + 1) + c] =
        row0 + r < limit && c < cols
            ? to_f32(src[(long long)(row0 + r) * rs + c])
            : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(CT)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Shape s, Strides st) {
  constexpr int LD = DMAX + 1, PS = CB + 1, DPT = DMAX / 32;
  extern __shared__ float fsm[];
  float* Ko = fsm;             // [CB][LD]
  float* Vo = Ko + CB * LD;    // [CB][LD]
  float* Qi = Vo + CB * LD;    // [CB][LD]
  float* Gi = Qi + CB * LD;    // [CB][LD]  dO
  float* Pt = Gi + CB * LD;    // [CB][PS]  Pᵀ
  float* St = Pt + CB * PS;    // [CB][PS]  dSᵀ
  float* Li = St + CB * PS;    // [CB]
  float* Di = Li + CB;         // [CB]

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int k0 = blockIdx.x * CB, hk = blockIdx.y, bb = blockIdx.z;
  load_f32<T, DMAX>(Ko, k + bb * st.k[0] + hk * st.k[2], st.k[1], k0, s.sk,
                    s.d, tid);
  load_f32<T, DMAX>(Vo, v + bb * st.v[0] + hk * st.v[2], st.v[1], k0, s.sk,
                    s.dv, tid);
  const int2 rows = query_rows(k0, CB, s);
  const int tiles = (rows.y - rows.x + CB - 1) / CB;

  float ak[CR][DPT] = {}, av[CR][DPT] = {};
  for (int it = 0; it < tiles * s.group; ++it) {
    const int h = hk * s.group + it / tiles;
    const int q0 = rows.x + (it % tiles) * CB;
    __syncthreads();  // the previous tile's readers are done
    load_f32<T, DMAX>(Qi, q + bb * st.q[0] + h * st.q[2], st.q[1], q0, s.sq,
                      s.d, tid);
    load_f32<T, DMAX>(Gi, g + bb * st.g[0] + h * st.g[2], st.g[1], q0, s.sq,
                      s.dv, tid);
    if (tid < CB) {
      const bool in = q0 + tid < s.sq;
      const long long at = ((long long)bb * s.hq + h) * s.sq + q0 + tid;
      Li[tid] = in ? lse[at] : 0.f;
      Di[tid] = in ? delta[at] : 0.f;
    }
    __syncthreads();
    // phase A: keys ty * CR + i against query tx
    float sv[CR] = {}, pv[CR] = {};
    for (int c = 0; c < s.d; ++c) {
      const float x = Qi[tx * LD + c];
#pragma unroll
      for (int i = 0; i < CR; ++i)
        sv[i] = fmaf(Ko[(ty * CR + i) * LD + c], x, sv[i]);
    }
    for (int c = 0; c < s.dv; ++c) {
      const float x = Gi[tx * LD + c];
#pragma unroll
      for (int i = 0; i < CR; ++i)
        pv[i] = fmaf(Vo[(ty * CR + i) * LD + c], x, pv[i]);
    }
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      const int r = ty * CR + i;
      const float p =
          live(q0 + tx, k0 + r, s) ? expf(sv[i] * s.scale - Li[tx]) : 0.f;
      Pt[r * PS + tx] = p;
      St[r * PS + tx] = p * (pv[i] - Di[tx]) * s.scale;
    }
    __syncthreads();
    // phase B: keys ty * CR + i, columns tx + 32 j
    for (int c = 0; c < CB; ++c) {
      float gq[DPT], qq[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        gq[j] = Gi[c * LD + tx + 32 * j];
        qq[j] = Qi[c * LD + tx + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < CR; ++i) {
        const float p = Pt[(ty * CR + i) * PS + c];
        const float ds = St[(ty * CR + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          av[i][j] = fmaf(p, gq[j], av[i][j]);
          ak[i][j] = fmaf(ds, qq[j], ak[i][j]);
        }
      }
    }
  }
  T* dkb = dk + bb * st.dk[0] + hk * st.dk[2];
  T* dvb = dv + bb * st.dv[0] + hk * st.dv[2];
#pragma unroll
  for (int i = 0; i < CR; ++i) {
    const int key = k0 + ty * CR + i;
    if (key >= s.sk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 32 * j;
      if (c < s.d) store(dkb + key * st.dk[1] + c, ak[i][j]);
      if (c < s.dv) store(dvb + key * st.dv[1] + c, av[i][j]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(CT)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Shape s,
                 Strides st) {
  constexpr int LD = DMAX + 1, PS = CB + 1, DPT = DMAX / 32;
  extern __shared__ float fsm[];
  float* Qo = fsm;             // [CB][LD]
  float* Go = Qo + CB * LD;    // [CB][LD]  dO
  float* Ki = Go + CB * LD;    // [CB][LD]
  float* Vi = Ki + CB * LD;    // [CB][LD]
  float* Sd = Vi + CB * LD;    // [CB][PS]  dS
  float* Lo = Sd + 2 * CB * PS;  // [CB]
  float* Do = Lo + CB;           // [CB]

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int q0 = blockIdx.x * CB, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / s.group;
  load_f32<T, DMAX>(Qo, q + bb * st.q[0] + h * st.q[2], st.q[1], q0, s.sq,
                    s.d, tid);
  load_f32<T, DMAX>(Go, g + bb * st.g[0] + h * st.g[2], st.g[1], q0, s.sq,
                    s.dv, tid);
  if (tid < CB) {
    const bool in = q0 + tid < s.sq;
    const long long at = ((long long)bb * s.hq + h) * s.sq + q0 + tid;
    Lo[tid] = in ? lse[at] : 0.f;
    Do[tid] = in ? delta[at] : 0.f;
  }
  const int2 cols = key_cols(q0, CB, s);
  const T* kb = k + bb * st.k[0] + hk * st.k[2];
  const T* vb = v + bb * st.v[0] + hk * st.v[2];

  float aq[CR][DPT] = {};
  for (int k0 = cols.x; k0 < cols.y; k0 += CB) {
    __syncthreads();
    load_f32<T, DMAX>(Ki, kb, st.k[1], k0, s.sk, s.d, tid);
    load_f32<T, DMAX>(Vi, vb, st.v[1], k0, s.sk, s.dv, tid);
    __syncthreads();
    // phase A: queries ty * CR + i against key tx
    float sv[CR] = {}, pv[CR] = {};
    for (int c = 0; c < s.d; ++c) {
      const float x = Ki[tx * LD + c];
#pragma unroll
      for (int i = 0; i < CR; ++i)
        sv[i] = fmaf(Qo[(ty * CR + i) * LD + c], x, sv[i]);
    }
    for (int c = 0; c < s.dv; ++c) {
      const float x = Vi[tx * LD + c];
#pragma unroll
      for (int i = 0; i < CR; ++i)
        pv[i] = fmaf(Go[(ty * CR + i) * LD + c], x, pv[i]);
    }
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      const int r = ty * CR + i;
      const float p =
          live(q0 + r, k0 + tx, s) ? expf(sv[i] * s.scale - Lo[r]) : 0.f;
      Sd[r * PS + tx] = p * (pv[i] - Do[r]) * s.scale;
    }
    __syncthreads();
    // phase B: queries ty * CR + i, columns tx + 32 j
    for (int c = 0; c < CB; ++c) {
      float kk[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kk[j] = Ki[c * LD + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < CR; ++i) {
        const float ds = Sd[(ty * CR + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) aq[i][j] = fmaf(ds, kk[j], aq[i][j]);
      }
    }
  }
  T* dqb = dq + bb * st.dq[0] + h * st.dq[2];
#pragma unroll
  for (int i = 0; i < CR; ++i) {
    const int row = q0 + ty * CR + i;
    if (row >= s.sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 32 * j;
      if (c < s.d) store(dqb + row * st.dq[1] + c, aq[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
inline unsigned cdiv(long long a, long long b) {
  return (unsigned)((a + b - 1) / b);
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename K>
int allow_smem(K kernel, size_t bytes, unsigned* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (*raised >> dev & 1u)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) *raised |= 1u << dev;
  return 0;
}

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, hkv;
  Shape s;
  Strides st;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const Args& a) {
  const long long rows = (long long)a.b * a.s.hq * a.s.sq;
  flash_bwd_delta<T><<<cdiv(rows, 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.delta, a.b,
      a.s, a.st);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_mma(const Args& a) {
  using C = Mma<D, DV>;
  static unsigned raised_dq = 0, raised_kv = 0;
  int rc = allow_smem(flash_bwd_dq_mma<D, DV>, C::DQ_BYTES, &raised_dq);
  if (!rc)
    rc = allow_smem(flash_bwd_dkdv_mma<D, DV>, C::DKDV_BYTES, &raised_kv);
  if (!rc) rc = launch_delta<bf16>(a);
  if (rc) return rc;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *g = static_cast<const bf16*>(a.g);
  flash_bwd_dq_mma<D, DV>
      <<<dim3(cdiv(a.s.sq, C::BO), a.s.hq, a.b), C::THREADS, C::DQ_BYTES,
         a.stream>>>(q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dq),
                     a.s, a.st);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_bwd_dkdv_mma<D, DV>
      <<<dim3(cdiv(a.s.sk, C::BO), a.hkv, a.b), C::THREADS, C::DKDV_BYTES,
         a.stream>>>(q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dk),
                     static_cast<bf16*>(a.dv), a.s, a.st);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_cc(const Args& a) {
  constexpr size_t bytes = cc_bytes<DMAX>();
  static unsigned raised_dq = 0, raised_kv = 0;
  int rc = allow_smem(flash_bwd_dq<T, DMAX>, bytes, &raised_dq);
  if (!rc) rc = allow_smem(flash_bwd_dkdv<T, DMAX>, bytes, &raised_kv);
  if (!rc) rc = launch_delta<T>(a);
  if (rc) return rc;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *g = static_cast<const T*>(a.g);
  flash_bwd_dq<T, DMAX><<<dim3(cdiv(a.s.sq, CB), a.s.hq, a.b), CT, bytes,
                          a.stream>>>(q, k, v, g, a.lse, a.delta,
                                      static_cast<T*>(a.dq), a.s, a.st);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  flash_bwd_dkdv<T, DMAX><<<dim3(cdiv(a.s.sk, CB), a.hkv, a.b), CT, bytes,
                            a.stream>>>(q, k, v, g, a.lse, a.delta,
                                        static_cast<T*>(a.dk),
                                        static_cast<T*>(a.dv), a.s, a.st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cc(const Args& a) {
  if (a.s.d <= 64) return launch_cc<T, 64>(a);
  if (a.s.d <= 128) return launch_cc<T, 128>(a);
  return launch_cc<T, 256>(a);
}

using MmaLaunch = int (*)(const Args&);

// The tensor-core instance for q/k head dim d and v head dim dv, or null.
MmaLaunch mma_instance(int d, int dv) {
  if (d == 64 && dv == 64) return launch_mma<64, 64>;
  if (d == 96 && dv == 96) return launch_mma<96, 96>;
  if (d == 128 && dv == 128) return launch_mma<128, 128>;
  if (d == 192 && dv == 128) return launch_mma<192, 128>;
  if (d == 256 && dv == 256) return launch_mma<256, 256>;
  return nullptr;
}

// cp.async's 16-byte copies and the 4-byte stores of bf16 pairs: every
// base 16-byte aligned and every stride a multiple of 8 elements.
bool aligned(const Args& a) {
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.g, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const long long* st = &a.st.q[0];
  for (int i = 0; i < 24; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Sq,Hq,D], k [B,Sk,Hkv,D], v [B,Sk,Hkv,Dv], out and dO [B,Sq,Hq,Dv],
// and the outputs dq, dk, dv of the shapes of q, k and v, each addressed by
// its (batch, seq, head) element strides, 24 in that order in `strides`,
// with the head dim contiguous; dtype 0 = f32, 1 = bf16 (all eight
// tensors); Dv <= D <= 256.  lse is the forward's contiguous f32
// [B,Hq,Sq]; delta a contiguous f32 [B,Hq,Sq] scratch the call fills.
// *kernel is set to the route taken: 0 = flash_bwd (CUDA cores),
// 1 = flash_bwd_mma (tensor cores).  Returns the first failing launch's
// cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* g, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int dtype,
                        int b, int hq, int hkv, int sq, int sk, int d,
                        int dv_dim, int valid_len, const long long* strides,
                        float scale, int causal, int window, void* stream,
                        int* kernel) {
  *kernel = -1;
  if (d < 1 || d > 256 || dv_dim < 1 || dv_dim > d || hkv < 1 ||
      hq % hkv != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, g, lse, delta, dq, dk, dv, b, hkv, {}, {},
         static_cast<cudaStream_t>(stream)};
  a.s = Shape{hq, hq / hkv, sq, sk, d, dv_dim,
              valid_len > 0 && valid_len < sk ? valid_len : sk, causal,
              window, scale};
  long long* st = &a.st.q[0];
  for (int i = 0; i < 24; ++i) st[i] = strides[i];
  const MmaLaunch mma = dtype == 1 ? mma_instance(d, dv_dim) : nullptr;
  if (mma && aligned(a)) {
    *kernel = 1;
    return mma(a);
  }
  *kernel = 0;
  return dtype == 0 ? dispatch_cc<float>(a) : dispatch_cc<bf16>(a);
}

}  // extern "C"
