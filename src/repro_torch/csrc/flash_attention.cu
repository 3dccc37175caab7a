// Flash-attention forward: online-softmax attention with causal, sliding
// window and valid-length masks, GQA, in the model layout [B, S, H, D].
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (the Pallas TPU kernel, body _kernel), whose grid
// (B, Hq, nq, nk) runs the kv dimension innermost and keeps m, l and acc in
// VMEM scratch across the nk steps of one query block.
//
// What bounds it on the H100: operations.  A causal prefill at S = 2048,
// D = 128 does ~69 GFLOP of products against ~100 MB of q/k/v/o, about
// 700 operations per byte, above the card's bf16 line (~295).
//
// Two kernels, one function.  bf16 inputs with D = 64 or 128 (every
// prefill of the served models) take flash_fwd_mma: warp-level mma.sync on
// the tensor cores (no wgmma, no TMA, no pipelining of the tile loads yet),
// described above it.  Everything else (f32, other head dims, unaligned
// rows) takes flash_fwd, all in f32 on the CUDA cores, built for head dims
// up to 64, 128 and 256 (gemma-2b's 256 needs 138 KB of shared memory):
//
// One block of 128 threads per (64 query rows, q head, batch).  The
// block loops over 32-column key tiles in order; the grid runs the blocks in
// parallel, so nothing carries between blocks.  The q tile (scaled by
// `scale` as it is loaded, like the Pallas kernel) stays in shared memory;
// each key tile is staged transposed (K^T) next to its V tile.  Thread
// (ty, tx) owns rows ty*8 .. ty*8+7 and, within a tile, score columns tx and
// tx+16 and output columns tx + 16*j; the row max and row sum reduce over
// the 16 lanes that share a row with shuffles.  m, l and acc live in
// registers.
//
// Both: only live key tiles are visited: below the valid length, at or
// before the block's last row when causal, and within the window of its
// first row, so a causal prefill skips about half the tiles
// (kernel.py:44-48).  Masked scores are -inf and take p = 0 explicitly, and
// the first live column gives corr = exp(-inf) = 0, so no exp(-inf - -inf)
// is formed; a row with no live column ends with l = 0 and writes 0
// (kernel.py:71-74).  Softmax statistics and accumulators are f32; stores
// round to the input's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // key columns per tile
constexpr int NT = 128;         // threads: 8 row groups x 16 lanes
constexpr int RPT = BQ / 8;     // rows per thread
constexpr int CPT = BK / 16;    // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (DMAX + 1) + (size_t)DMAX * (BK + 1) +
          (size_t)BK * DMAX + (size_t)BQ * (BK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int group, int sq,
              int sk, int d, int valid_len, long long q_sb, long long q_ss,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh, long long o_sb,
              long long o_ss, long long o_sh, float scale, int causal,
              int window) {
  constexpr int QS = DMAX + 1;  // padded strides: no bank conflicts
  constexpr int KS = BK + 1;
  constexpr int PS = BK + 1;
  constexpr int DPT = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][QS]   q * scale
  float* Kt = Qs + BQ * QS;       // [DMAX][KS] key tile, transposed
  float* Vs = Kt + DMAX * KS;     // [BK][DMAX] value tile
  float* Ps = Vs + BK * DMAX;     // [BQ][PS]   probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const T* qb = q + bb * q_sb + h * q_sh;
  const T* kb = k + bb * k_sb + (h / group) * k_sh;
  const T* vb = v + bb * v_sb + (h / group) * v_sh;

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_f32(qb[(q0 + r) * q_ss + c]) * scale;
    Qs[r * QS + c] = x;
  }

  // live key range of this block: [k_begin, k_end)
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = min(sk, valid_len);
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int r = i / DMAX, c = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = to_f32(kb[(k0 + r) * k_ss + c]);
        vx = to_f32(vb[(k0 + r) * v_ss + c]);
      }
      Kt[c * KS + r] = kx;
      Vs[r * DMAX + c] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float kv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = Qs[(ty * RPT + i) * QS + c];
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < valid_len && col < sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // m[i] = -inf and m_new finite gives exp(-inf) = 0; both -inf: the
      // row has seen nothing yet and its acc and l are 0 whatever corr is
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * RPT + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[kk * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty * RPT + i) * PS + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + bb * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(ob + row * o_ss + c, acc[i][j] * inv);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int d, int valid_len,
           const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd<T, DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq / hkv, sq, sk, d,
      valid_len, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int sk, int d, int valid_len,
             const long long* st, float scale, int causal, int window,
             cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, d, valid_len, st,
                         scale, causal, window, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, d, valid_len, st,
                          scale, causal, window, stream);
  return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, sk, d, valid_len, st,
                        scale, causal, window, stream);
}

// ---------------------------------------------------------------------------
// bf16 with D = 64 or 128: products on the tensor cores (mma.sync
// m16n8k16, f32 accumulate).  One block of 4 warps per (64 query rows,
// q head, batch); each warp owns 16 query rows and walks 64-key tiles.
// The q fragments stay in registers for the whole walk; S = q k^T and
// O += P V are warp-level mma; P goes from the S accumulators to the A
// operand of P V in registers, rounded to bf16 as the tensor cores take it.
// Scores are scaled by scale * log2(e) in f32, so the softmax uses exp2.
// Query tiles run heaviest first (the last rows see the most keys).
// ---------------------------------------------------------------------------
constexpr int MQ = 64;   // query rows per block (16 per warp)
constexpr int MK = 64;   // keys per tile

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(MQ + 2 * MK) * (D + 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows, int rows) {
  constexpr int DS = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * DS + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int group, int sq, int sk,
                  int valid_len, long long q_sb, long long q_ss,
                  long long q_sh, long long k_sb, long long k_ss,
                  long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, long long o_sb, long long o_ss,
                  long long o_sh, float scale_log2, int causal, int window) {
  constexpr int DS = D + 8;  // padded rows: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ * DS;
  __nv_bfloat16* Vs = Ks + MK * DS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const __nv_bfloat16* qb = q + bb * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + bb * k_sb + (h / group) * k_sh;
  const __nv_bfloat16* vb = v + bb * v_sb + (h / group) * v_sh;

  load_tile<D>(Qs, qb, q_ss, q0, sq, MQ);
  __syncthreads();
  uint32_t qf[D / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Qs + (wr + g) * DS + kk * 16 + t * 2;
    qf[kk][0] = lds32(p);
    qf[kk][1] = lds32(p + 8 * DS);
    qf[kk][2] = lds32(p + 8);
    qf[kk][3] = lds32(p + 8 * DS + 8);
  }

  const int q_last = min(q0 + MQ, sq) - 1;
  int k_end = min(sk, valid_len);
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / MK) * MK;

  const int row0 = q0 + wr + g;  // this thread's rows: row0 and row0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += MK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, kb, k_ss, k0, sk, MK);
    load_tile<D>(Vs, vb, v_ss, k0, sk, MK);
    __syncthreads();

    float s[MK / 8][4];
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * DS + kk * 16 + t * 2;
        mma_bf16(s[nt], qf[kk], lds32(p), lds32(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        bool ok = col < valid_len && col < sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = m_new[i] == -INFINITY ? 1.f : exp2f(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= corr[i];  // this thread's share of the row sum
    }
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == -INFINITY
                            ? 0.f
                            : exp2f(s[nt][e] - m_new[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // V^T fragments of two 8-wide d tiles per ldmatrix (x4, transposed)
      const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
            Vs + krow * DS + dn * 8 + (lane >> 4) * 8));
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(oacc[dn], a, b0, b1);
        mma_bf16(oacc[dn + 1], a, b2, b3);
      }
    }
  }

  __nv_bfloat16* ob = o + bb * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + i * 8;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + j * 8 + t * 2) =
          __floats2bfloat162_rn(oacc[j][2 * i] * inv,
                                oacc[j][2 * i + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int sk, int valid_len,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + MQ - 1) / MQ, hq, b);
  flash_fwd_mma<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq / hkv, sq, sk, valid_len, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

// The tensor-core kernel reads 16-byte vectors: every row start must be
// 16-byte aligned (pointers, and strides a multiple of 8 elements).
bool mma_ready(const void* q, const void* k, const void* v, const void* o,
               int d, const long long* st) {
  if (d != 64 && d != 128) return false;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], o [B,Sq,Hq,D], each addressed by its
// (batch, seq, head) element strides with D contiguous; dtype 0 = f32,
// 1 = bf16; D <= 256.  Returns the launch's cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int sq, int sk, int d,
                    int valid_len, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long o_sb, long long o_ss,
                    long long o_sh, float scale, int causal, int window,
                    void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, valid_len, st,
                           scale, causal, window, s);
  if (dtype == 1 && mma_ready(q, k, v, o, d, st))
    return d == 64 ? launch_mma<64>(q, k, v, o, b, hq, hkv, sq, sk, valid_len,
                                    st, scale, causal, window, s)
                   : launch_mma<128>(q, k, v, o, b, hq, hkv, sq, sk,
                                     valid_len, st, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                   valid_len, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
