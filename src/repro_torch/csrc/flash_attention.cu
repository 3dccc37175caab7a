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
// Two kernels, one function; the dispatch looks at dtype, head dim and
// alignment only.  bf16 with D = 64 or 128 whose bases are 16-byte aligned
// and whose strides are multiples of 8 elements (every prefill of the
// served models) takes flash_fwd_wgmma, warp-specialised wgmma fed by TMA,
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
// bf16 with D = 64 or 128: flash_fwd_wgmma, warpgroup MMA fed by TMA.
//
// One CTA per (TQ query rows, q head, batch), of one producer warpgroup and
// NC consumer warpgroups of 64 query rows each: NC = 2 at D 128 (TQ 128),
// NC = 3 at D 64 (TQ 192; the products are half as long there for the same
// softmax, so a third warpgroup keeps more of them in flight).
// - The producer gives up registers (setmaxnreg 24) and one thread starts
//   every TMA load: the q tile once, then each live key tile's K and V into
//   a ring of STAGES shared-memory stages, each completing on that stage's
//   "full" mbarrier (expect_tx bytes), after waiting on the stage's "empty"
//   mbarrier.  K and V have a full and an empty barrier each, so a stage's
//   K is refilled as soon as S of its tile is done.
// - The consumers (setmaxnreg 240 at NC 2, 160 at NC 3) take TK-key tiles
//   in order.  S = Q K^T is wgmma m64n128k16 with both operands in shared
//   memory (K is K-major as stored, D contiguous).  The online softmax runs
//   in registers, the row max and sum reduced over the 4 lanes that share a
//   row.  O += P V takes P in bf16 registers as the A operand (the S
//   accumulator fragment is the A fragment, no shuffles) and V as the
//   MN-major B operand (transposed by the descriptor).  Tile j's S = Q K^T
//   is started together with tile j-1's P V, so j's softmax overlaps that
//   product, and the consumer warpgroups take turns to start them (named
//   barriers), so one's softmax also overlaps another's products.
// Scores are scaled by scale * log2(e) in f32 and the softmax uses exp2.
// The mask runs only on tiles that straddle the diagonal, the window's
// lower edge or min(sk, valid_len): a tile wholly inside takes the
// unmasked path (softmax_tile<false>).  The rule (key_tiles, tile_full) is
// the one written down in kernels/flash_attention/kernel.py
// (classify_key_tiles).  The epilogue writes O / l in bf16 over the
// warpgroup's own q rows in shared memory and stores them with TMA.
// CTAs run in chunks of (batch, kv head) pairs whose K and V fit in a
// third of L2; inside a chunk the heaviest query tiles go first and the q
// heads of one kv head sit side by side, so K and V come from L2.
//
// Where trouble is likely, and what the code does about it:
// - Tensor maps are 4-D, [D, H, S, B], with the caller's strides.  A 2-D
//   [B*S, H*D] map would let the ragged last tile of one batch read the
//   next batch's rows, and a TMA store through it would overwrite them;
//   the 4-D map zero-fills loads and clips stores past S by itself.
// - With the 128-byte swizzle a box's inner extent is at most 128 bytes
//   (64 bf16), so at D 128 each tile is two boxes of 64 columns, one after
//   the other in shared memory.  The K-major descriptors (Q, K) step 32
//   bytes per 16 columns inside a box and jump to the second box after 64;
//   the MN-major descriptor of V spans both boxes with its leading byte
//   offset.  Every box starts on a 1024-byte boundary, the swizzle's period.
// - cuTensorMapEncodeTiled lives in libcuda, which the build does not link
//   (no -lcuda): the runtime hands it over once (cudaGetDriverEntryPoint).
// - Each CUtensorMap is encoded on the host per call and passed by value as
//   a const __grid_constant__ parameter, so a CUDA graph that captures the
//   call keeps valid maps; no map lives in a device buffer.
// - wgmma accumulators and the P registers must not be touched while a
//   wgmma is in flight: each product's registers are read only after a
//   wgmma.wait_group that retires it, and fenced for the compiler there;
//   O is rescaled only once the previous P V has retired, and wgmma.fence
//   comes before registers feed the next product.  A wrong parity on a
//   full or empty barrier would show as run-to-run differences, not as a
//   crash: the card tests compare calls bit for bit.
// ---------------------------------------------------------------------------
constexpr int TK = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int WG_THREADS = 128;
constexpr int BOX = 64;        // bf16 columns per TMA box (128 bytes)
constexpr int ROW_BYTES = 128; // one row of a box in shared memory

// Consumer warpgroups per CTA, 64 query rows each.  At D 64 the products
// are half as long for the same softmax, so a third warpgroup keeps more of
// them in flight and each K/V tile feeds 192 rows.
constexpr int consumer_groups(int d) { return d == 64 ? 3 : 2; }

template <int D>
struct WgSmem {
  static constexpr int NC = consumer_groups(D);
  static constexpr int TQ = 64 * NC;              // query rows per CTA
  static constexpr int Q_HALF = TQ * ROW_BYTES;   // one 64-column box of q
  static constexpr int KV_HALF = TK * ROW_BYTES;  // one box of a K or V tile
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int KV_BYTES = TK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then full_k, full_v, empty_k and empty_v per stage; 1024
  // bytes of slack to align the base to the swizzle's period
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map, coordinates innermost first (d, head, seq, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler the registers may change here: nothing that reads or
// reuses them moves across a wgmma that is in flight.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC32(d) ACC16(d, 0), ACC16(d, 16)
#define ACC64(d) ACC32(d), ACC16(d, 32), ACC16(d, 48)
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared
// memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The live key tiles of a query tile [q0, q_last]: `count` tiles of TK
// from `first`.  Producer and consumers walk the same list.
struct KeyTiles {
  int first, count;
};

__device__ __forceinline__ KeyTiles key_tiles(int q0, int q_last, int kv_lim,
                                              int causal, int window) {
  const int hi = causal ? min(kv_lim, q_last + 1) : kv_lim;
  const int lo = window > 0 ? max(0, q0 - window + 1) / TK * TK : 0;
  return {lo, hi > lo ? (hi - lo + TK - 1) / TK : 0};
}

// Every (row, col) of the tile is live: it lies wholly below kv_lim, below
// the diagonal and inside the window.
__device__ __forceinline__ bool tile_full(int k0, int q0, int q_last,
                                          int kv_lim, int causal, int window) {
  return k0 + TK <= kv_lim && (!causal || k0 + TK - 1 <= q0) &&
         (window <= 0 || q_last - k0 < window);
}

// Online softmax of one tile for this thread's two rows (row0, row0 + 8):
// s in, p out (same registers), m and l updated, corr returned per row.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int row0, int col0, int kv_lim,
                                             int causal, int window,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (MASK) {
        const int row = row0 + (e >> 1) * 8, col = col0 + 8 * j + (e & 1);
        const bool live = col < kv_lim && (!causal || col <= row) &&
                          (window <= 0 || row - col < window);
        x = live ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float m_new[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m[i], mx[i]);
    // m = -inf and m_new finite gives exp2(-inf) = 0; both -inf: the row
    // has seen nothing yet and its O and l are 0 whatever corr is
    corr[i] = m_new[i] == -INFINITY ? 1.f : exp2_approx(m[i] - m_new[i]);
    m[i] = m_new[i];
    l[i] *= corr[i];  // this thread's share of the row sum
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float p = MASK && x == -INFINITY
                          ? 0.f
                          : exp2_approx(x - m_new[e >> 1]);
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

template <int D>
__global__ void __launch_bounds__((consumer_groups(D) + 1) * WG_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map, int hq,
                    int group, int batch, int sq, int kv_lim,
                    float scale_log2, int causal, int window, int chunk) {
  using L = WgSmem<D>;
  constexpr int HALVES = D / BOX, NC = L::NC, TQ = L::TQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  // barriers: q_full, then per stage full_k, full_v, empty_k, empty_v
  const uint32_t q_full = sbase + L::BAR_OFF;
  auto bar = [&](int kind, int s) {
    return q_full + 8 * (1 + kind * STAGES + s);
  };
  auto full_k = [&](int s) { return bar(0, s); };
  auto full_v = [&](int s) { return bar(1, s); };
  auto empty_k = [&](int s) { return bar(2, s); };
  auto empty_v = [&](int s) { return bar(3, s); };
  auto k_tile = [&](int s) { return sbase + L::K_OFF + s * L::KV_BYTES; };
  auto v_tile = [&](int s) { return sbase + L::V_OFF + s * L::KV_BYTES; };

  // CTAs run in chunks of `chunk` (batch, kv head) pairs, whose K and V
  // fit in L2 together; inside a chunk the heaviest query tiles go first,
  // the q heads of one kv head side by side
  const int n_q = (sq + TQ - 1) / TQ;
  const int pairs = batch * (hq / group);
  const int per_chunk = chunk * group * n_q;
  const int first = blockIdx.x / per_chunk * chunk;
  const int in_chunk = blockIdx.x % per_chunk;
  const int width = min(chunk, pairs - first) * group;  // q heads in chunk
  const int q0 = (n_q - 1 - in_chunk / width) * TQ;
  const int pair = first + in_chunk % width / group;
  const int bb = pair / (hq / group);
  const int h = pair % (hq / group) * group + in_chunk % group;
  const int q_last = min(q0 + TQ, sq) - 1;
  const KeyTiles tiles = key_tiles(q0, q_last, kv_lim, causal, window);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), NC * WG_THREADS / 32);  // every consumer warp
      mbar_init(empty_v(s), NC * WG_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // only the q rows below sq: a box wholly past S is never asked for
      const int q_boxes = min(NC, (sq - q0 + 63) / 64);
      mbar_expect_tx(q_full, q_boxes * HALVES * 64 * ROW_BYTES);
      for (int w = 0; w < q_boxes; ++w)
        for (int x = 0; x < HALVES; ++x)
          tma_load(sbase + x * L::Q_HALF + w * 64 * ROW_BYTES, &q_map, q_full,
                   x * BOX, h, q0 + 64 * w, bb);
      const int kvh = h / group;
      for (int it = 0; it < tiles.count; ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int k0 = tiles.first + it * TK;
        // a stage's K is free once S of its tile is done, its V once P V is
        mbar_wait(empty_k(s), phase ^ 1);
        mbar_expect_tx(full_k(s), L::KV_BYTES);
        for (int x = 0; x < HALVES; ++x)
          tma_load(k_tile(s) + x * L::KV_HALF, &k_map, full_k(s), x * BOX,
                   kvh, k0, bb);
        mbar_wait(empty_v(s), phase ^ 1);
        mbar_expect_tx(full_v(s), L::KV_BYTES);
        for (int x = 0; x < HALVES; ++x)
          tma_load(v_tile(s) + x * L::KV_HALF, &v_map, full_v(s), x * BOX,
                   kvh, k0, bb);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----------------------------------
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * c + 16 * warp + g;  // and row0 + 8
  const uint32_t q_rows = sbase + 64 * ROW_BYTES * c;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sc[64];            // S of the tile in hand, then its P in f32
  uint32_t p[TK / 16][4];  // P of the previous tile in bf16

  // S = Q K^T of tile `it` into sc, started and committed, not waited for
  auto start_qk = [&](int it) {
    const uint32_t k_src = k_tile(it % STAGES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns of D a step: 32 bytes inside a box, then the next box
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n128(sc,
                    sw128_desc(q_rows + (kk / 4) * L::Q_HALF + off, 16, 1024),
                    sw128_desc(k_src + (kk / 4) * L::KV_HALF + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile `it` (P in p), started and committed
  auto start_pv = [&](int it) {
    const uint32_t v_src = v_tile(it % STAGES);
    mbar_wait(full_v(it % STAGES), (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      // 16 keys a step (2048 bytes); the two boxes of D lie KV_HALF apart
      // (the descriptor's leading byte offset)
      wgmma_rs(o, p[kk],
               sw128_desc(v_src + kk * 16 * ROW_BYTES, L::KV_HALF, 1024));
    wgmma_commit();
  };
  // the online softmax of tile `it` on sc, masked only where it straddles
  auto softmax = [&](int it) {
    const int k0 = tiles.first + it * TK;
    if (tile_full(k0, q0, q_last, kv_lim, causal, window))
      softmax_tile<false>(sc, m, l, corr, row0, k0 + 2 * t, kv_lim, causal,
                          window, scale_log2);
    else
      softmax_tile<true>(sc, m, l, corr, row0, k0 + 2 * t, kv_lim, causal,
                         window, scale_log2);
  };
  // P in bf16: the accumulator fragment of n8 blocks 2kk and 2kk+1 is the
  // A fragment of the kk-th 16 keys
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // Tile `it`'s S = Q K^T runs beside tile it-1's P V, and its softmax
  // overlaps that product; O is rescaled once P V has retired.  The
  // warpgroups take turns, in order, to start their products (named
  // barriers NC + 1 + c), so one's softmax runs while another's products
  // fill the tensor cores; warpgroup 0 goes first.
  const int n = tiles.count;
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(NC + 1 + c),
                 "r"(2 * WG_THREADS));
  };
  auto your_turn = [&](bool last) {
    // the last warpgroup's last hand-over would have no taker
    if (!(last && c == NC - 1))
      asm volatile("bar.arrive %0, %1;\n" ::"r"(NC + 1 + (c + 1) % NC),
                   "r"(2 * WG_THREADS));
  };
  mbar_wait(q_full, 0);
  if (n > 0) {
    if (c == NC - 1) your_turn(false);
    mbar_wait(full_k(0), 0);
    my_turn();
    start_qk(0);
    your_turn(false);
    wgmma_wait<0>();
    reg_fence(sc);
    if (lane == 0) mbar_arrive(empty_k(0));
    softmax(0);  // O is 0: nothing to rescale
    pack_p();
  }
  for (int it = 1; it < n; ++it) {
    mbar_wait(full_k(it % STAGES), (it / STAGES) & 1);
    my_turn();
    start_qk(it);
    start_pv(it - 1);
    your_turn(false);
    wgmma_wait<1>();  // S of tile it
    reg_fence(sc);
    if (lane == 0) mbar_arrive(empty_k(it % STAGES));
    softmax(it);
    wgmma_wait<0>();  // P V of tile it-1
    reg_fence(o);
    reg_fence(p);
    if (lane == 0) mbar_arrive(empty_v((it - 1) % STAGES));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pack_p();
  }
  if (n > 0) {
    my_turn();
    start_pv(n - 1);
    your_turn(true);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(p);
  }

  // ---- epilogue: O / l in bf16 over this warpgroup's q rows, then TMA ----
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;  // row within the warpgroup
      // column 8j + 2t: box j / 8, 16-byte chunk j % 8, swizzled by r % 8
      const int off = (j / 8) * L::Q_HALF + r * ROW_BYTES +
                      (((j % 8) ^ (r % 8)) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + 64 * ROW_BYTES * c + off) =
          pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "r"(WG_THREADS) : "memory");
  if (tid == 0 && q0 + 64 * c < sq) {
    for (int x = 0; x < HALVES; ++x)
      tma_store(&o_map, q_rows + x * L::Q_HALF, x * BOX, h, q0 + 64 * c, bb);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, taken from libcuda once (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A failed encode returns this plus the CUresult (error_string names it).
constexpr int kEncodeFailed = 10000;

int get_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A 4-D bf16 map [D, H, S, B] over the caller's strides (elements), boxes
// of 64 columns x `rows` rows, 128-byte swizzle, zero fill past the edges.
// A stride of an extent-1 dimension is never stepped; it is replaced by
// the packed one, which the encoder takes.
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d,
               int h, int s, int b, long long st_b, long long st_s,
               long long st_h, int rows) {
  const long long sh = h > 1 ? st_h : d;
  const long long ss = s > 1 ? st_s : sh * h;
  const long long sb = b > 1 ? st_b : ss * s;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h,
                              (cuuint64_t)std::max(s, 1), (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int sq, int sk, int valid_len,
                 const long long* st, float scale, int causal, int window,
                 cudaStream_t stream) {
  constexpr int smem = WgSmem<D>::BYTES;
  // the shared-memory limit is raised once per device, not per launch
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised |= 1u << dev;
  }
  EncodeTiled encode;
  int rc = get_encoder(&encode);
  CUtensorMap maps[4];
  if (!rc)
    rc = encode_map(encode, &maps[0], q, D, hq, sq, b, st[0], st[1], st[2],
                    64);
  if (!rc)
    rc = encode_map(encode, &maps[1], k, D, hkv, sk, b, st[3], st[4], st[5],
                    TK);
  if (!rc)
    rc = encode_map(encode, &maps[2], v, D, hkv, sk, b, st[6], st[7], st[8],
                    TK);
  if (!rc)
    rc = encode_map(encode, &maps[3], o, D, hq, sq, b, st[9], st[10], st[11],
                    64);
  if (rc) return rc;
  constexpr int TQ = WgSmem<D>::TQ;
  const long long blocks = (long long)((sq + TQ - 1) / TQ) * hq * b;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // (batch, kv head) pairs whose K and V take 16 MB, a third of L2
  const long long pair_bytes = 4LL * std::max(sk, 1) * D;
  const int chunk = (int)std::min<long long>(
      (long long)b * hkv, std::max(1LL, (16LL << 20) / pair_bytes));
  flash_fwd_wgmma<D><<<(unsigned)blocks, (WgSmem<D>::NC + 1) * WG_THREADS,
                       smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], hq, hq / hkv, b, sq,
      std::min(sk, valid_len), scale * 1.4426950408889634f, causal, window,
      chunk);
  return (int)cudaGetLastError();
}

// TMA reads and writes whole rows from 16-byte aligned addresses: every
// base 16-byte aligned and every stride a multiple of 8 elements.
bool tma_ready(const void* q, const void* k, const void* v, const void* o,
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
  if (code >= kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], o [B,Sq,Hq,D], each addressed by its
// (batch, seq, head) element strides with D contiguous; dtype 0 = f32,
// 1 = bf16; D <= 256.  *kernel is set to the kernel launched: 0 =
// flash_fwd (CUDA cores), 1 = flash_fwd_wgmma (tensor cores).  Returns the
// launch's cudaError_t, or kEncodeFailed + a CUresult.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int sq, int sk, int d,
                    int valid_len, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long o_sb, long long o_ss,
                    long long o_sh, float scale, int causal, int window,
                    void* stream, int* kernel) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *kernel = -1;
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && tma_ready(q, k, v, o, d, st)) {
    *kernel = 1;
    return d == 64 ? launch_wgmma<64>(q, k, v, o, b, hq, hkv, sq, sk,
                                      valid_len, st, scale, causal, window, s)
                   : launch_wgmma<128>(q, k, v, o, b, hq, hkv, sq, sk,
                                       valid_len, st, scale, causal, window,
                                       s);
  }
  *kernel = 0;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, valid_len, st,
                           scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                   valid_len, st, scale, causal, window, s);
  *kernel = -1;
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
