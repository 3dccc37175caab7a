// W8A16 matmul: out[M,N] = (x[M,K] · f32(w_q[K,N])) * scale[N], in x's
// type, with int8 weights and a per-output-channel f32 scale.
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py, int8_matmul_kernel
// (the Pallas TPU kernel, body _kernel), whose grid (M/bm, N/bn, K/bk) runs
// K innermost, keeps an f32 accumulator in VMEM scratch across the K steps
// and applies the scale once at the last one.  Its wrapper pads every
// operand to whole tiles; here the kernels mask the ragged edges
// themselves, so no padded copy of x is made.
//
// What bounds it on the H100: at decode (M <= 16) bytes: every weight byte
// is read once and used by only M rows, so the int8 weight (half of a bf16
// one) sets the time.  At prefill (M in the thousands) operations.
//
// Three kernels, one function; the route is chosen by the caller
// (kernels/int8_matmul/kernel.py, choose_route: dtype, M and TMA's
// alignment rules) and checked here, never changed:
// - w8a16_wgmma (bf16 x, prefill sizes): a mixed-input wgmma GEMM fed by
//   TMA, described where it is defined below.  The weight is first
//   repacked into the order of wgmma's A fragment by pack_fragments (one
//   bytes-bound pass a call).
// - w8a16_mma (bf16 x, decode and the LM head, and shapes TMA cannot
//   take): tensor cores through mma.sync m16n8k16, f32 accumulate.  The
//   int8 tile is read from device memory as int8 and widened to bf16
//   (exact for -127..127) as it is stored to shared memory, in a
//   pair-interleaved layout: word (kp, n) holds bf16(w[2kp][n]) in its low
//   half and bf16(w[2kp+1][n]) in its high half, which is exactly the pair
//   the B fragment wants (k = 2t, 2t+1 of column g).  The store is four
//   16-byte writes per (2 rows x 16 columns) chunk and the fragment reads
//   are conflict-free (row stride = 8 mod 32 words).  The next K tile is
//   loaded into registers while the tensor cores work on this one.  Two
//   tilings: 16 x 128 x 64 with 4 warps for M <= 16 (decode), 128 x 128 x 64
//   with 8 warps otherwise.
// - w8a16_f32 (f32 x): CUDA cores, FFMA in f32 throughout (no TF32, which
//   keeps 10 mantissa bits), 64 x 64 x 32 tiles, 16 outputs a thread.
// The last two: where the output tiles alone leave the card short of
// blocks (decode's 16 to 48 tiles on 132 SMs), K is split over blockIdx.z
// into contiguous runs of tiles; each split writes its f32 partial sums to
// a workspace and reduce_splits adds them in split order (deterministic, no
// float atomics), then scales and casts.  One split scales and casts in
// the kernel's own epilogue.  16-byte loads are taken only where every row
// start is 16-byte aligned (K % 8 == 0 for x, N % 16 == 0 for w); other
// shapes load element by element, zero-filled past M, N and K.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// K tiles of the product: every one of the K terms is summed, so a ragged
// last tile counts as a whole one (its missing rows load as zeros).
inline int k_tiles(int k, int bk) { return cdiv(k, bk); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The scale of output column n, applied once to the f32 sum.
__device__ __forceinline__ float scaled(float acc,
                                        const float* __restrict__ scale,
                                        int n) {
  return acc * scale[n];
}

// One output element: scaled and cast, or (split K) the raw partial sum
// into this split's slice of the workspace.
template <typename T>
__device__ __forceinline__ void emit(T* __restrict__ out,
                                     float* __restrict__ ws,
                                     const float* __restrict__ scale, int m,
                                     int n, int M, int N, float acc) {
  if (m >= M || n >= N) return;
  const size_t i = (size_t)m * N + n;
  if (ws)
    ws[(size_t)blockIdx.z * M * N + i] = acc;
  else
    store(out + i, scaled(acc, scale, n));
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x[m, k .. k+7] as 8 bf16, zero past M and K.  vec: K % 8 == 0 and x is
// 16-byte aligned, so a chunk lies wholly inside or outside K.
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x,
                                         int m, int k, int M, int K,
                                         bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (m >= M || k >= K) return v;
  const __nv_bfloat16* p = x + (size_t)m * K + k;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = k + 2 * j < K ? h[2 * j] : 0u;
    const uint32_t hi = k + 2 * j + 1 < K ? h[2 * j + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// w[k, n .. n+15] as 16 int8 bytes, zero past K and N.  vec: N % 16 == 0
// and w is 16-byte aligned.
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w, int k,
                                          int n, int K, int N, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K || n >= N) return v;
  const int8_t* p = w + (size_t)k * N + n;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n + j < N) b[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ float byte_f32(uint32_t word, int j) {
  return (float)(int8_t)((word >> (8 * j)) & 0xffu);
}

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
    w8a16_mma(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ w, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M,
              int N, int K, int nk, int kt_per, int vec_x, int vec_w) {
  constexpr int NTH = 32 * WM * WN;
  constexpr int AS = BK + 8;                 // bf16 per As row (padded)
  constexpr int BS = BN + 8;                 // words per Bs row (= 8 mod 32)
  constexpr int XCH = BM * BK / 8;           // 8-element chunks of x
  constexpr int WCH = (BK / 2) * (BN / 16);  // 2 x 16 chunks of w
  constexpr int XPT = (XCH + NTH - 1) / NTH;
  constexpr int WPT = (WCH + NTH - 1) / NTH;
  constexpr int MT = BM / WM / 16;           // m16 tiles per warp
  constexpr int NT = BN / WN / 8;            // n8 tiles per warp
  __shared__ __align__(16) __nv_bfloat16 As[BM * AS];
  __shared__ __align__(16) uint32_t Bs[(BK / 2) * BS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * kt_per, kt1 = min(nk, kt0 + kt_per);

  uint4 xr[XPT], wr[WPT][2];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * NTH;
      if (c < XCH)
        xr[i] = load_x8(x, m0 + c / (BK / 8), k0 + (c % (BK / 8)) * 8, M, K,
                        vec_x);
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int c = tid + i * NTH;
      if (c < WCH) {
        const int k = k0 + 2 * (c / (BN / 16)), n = n0 + (c % (BN / 16)) * 16;
        wr[i][0] = load_w16(w, k, n, K, N, vec_w);
        wr[i][1] = load_w16(w, k + 1, n, K, N, vec_w);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * NTH;
      if (c < XCH)
        *reinterpret_cast<uint4*>(As + (c / (BK / 8)) * AS +
                                  (c % (BK / 8)) * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int c = tid + i * NTH;
      if (c < WCH) {
        const uint32_t lo[4] = {wr[i][0].x, wr[i][0].y, wr[i][0].z,
                                wr[i][0].w};
        const uint32_t hi[4] = {wr[i][1].x, wr[i][1].y, wr[i][1].z,
                                wr[i][1].w};
        uint4* dst = reinterpret_cast<uint4*>(Bs + (c / (BN / 16)) * BS +
                                              (c % (BN / 16)) * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = pack_bf16(byte_f32(lo[q], j), byte_f32(hi[q], j));
          dst[q] = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    stash();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight while the tile is used
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p =
            As + (wm * (BM / WM) + mt * 16 + g) * AS + kk * 16 + t * 2;
        a[mt][0] = lds32(p);
        a[mt][1] = lds32(p + 8 * AS);
        a[mt][2] = lds32(p + 8);
        a[mt][3] = lds32(p + 8 * AS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* q =
            Bs + (kk * 8 + t) * BS + wn * (BN / WN) + nt * 8 + g;
        const uint32_t b0 = q[0], b1 = q[4 * BS];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // the tile's readers are done before the next stash
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = m0 + wm * (BM / WM) + mt * 16 + g;
      const int col = n0 + wn * (BN / WN) + nt * 8 + 2 * t;
      emit(out, ws, scale, row, col, M, N, acc[mt][nt][0]);
      emit(out, ws, scale, row, col + 1, M, N, acc[mt][nt][1]);
      emit(out, ws, scale, row + 8, col, M, N, acc[mt][nt][2]);
      emit(out, ws, scale, row + 8, col + 1, M, N, acc[mt][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// f32 x on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int FM = 64, FN = 64, FK = 32, FT = 256;  // tile, threads

__global__ void __launch_bounds__(FT)
    w8a16_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
              float* __restrict__ ws, int M, int N, int K, int nk,
              int kt_per) {
  __shared__ float Xs[FM][FK + 1];
  __shared__ float Ws[FK][FN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int kt0 = blockIdx.z * kt_per, kt1 = min(nk, kt0 + kt_per);

  float acc[4][4] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * FK;
    for (int i = tid; i < FM * FK; i += FT) {
      const int r = i / FK, c = i % FK;
      Xs[r][c] = (m0 + r < M && k0 + c < K)
                     ? x[(size_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < FK * FN; i += FT) {
      const int r = i / FN, c = i % FN;
      Ws[r][c] = (k0 + r < K && n0 + c < N)
                     ? (float)w[(size_t)(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(out, ws, scale, m0 + ty * 4 + i, n0 + tx + 16 * j, M, N,
           acc[i][j]);
}

// The second pass of a split K: the splits' partial sums added in split
// order, scaled and cast.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    store(out + i, scaled(s, scale, (int)(i % N)));
  }
}

// ---------------------------------------------------------------------------
// bf16 x at prefill sizes: w8a16_wgmma, a mixed-input wgmma GEMM fed by TMA.
//
// The product is computed transposed, out^T[N, M] = w_q^T · x^T, so that the
// int8 weight is wgmma's A operand, taken from registers and widened there,
// and x is the B operand in shared memory, K-major as it is stored (as K is
// in flash's Q·K^T).  The widened weight never goes through shared memory:
// per wgmma m64n256k16 the SM reads 8 KB of x and 1 KB of int8 from it,
// about 72 of its 128 bytes a clock at the tensor cores' rate, where a
// bf16 copy of the weight staged MN-major (as V in flash) would add a
// 32 KB write and a 16 KB read per 64-deep K step of a 128 x 256 tile and
// use the whole shared-memory bandwidth.
//
// Output tiles of TN = 128 weight columns x TM = 256 x rows, the weight's
// column blocks innermost, so the CTAs in flight share their x rows in L2.
// A persistent grid of at most one CTA per SM walks them (tile blockIdx.x,
// + gridDim.x, ...); a CTA is one producer warpgroup and two consumer
// warpgroups, and its ring runs on from one tile into the next, so the
// next tile's first stages load while the consumers store this one's
// output.  (One CTA per tile measured slower at the qwen3-1.7b prefill
// product.)
// - The weight fragments.  The A fragment of m64nNk16 wants, per thread,
//   k-pairs of one weight column, and w_q [K, N] keeps columns apart, so a
//   first pass (pack_fragments, one block per 64 x 128 tile, bytes-bound:
//   K·N read and written once) rewrites w_q in fragment order: per (column
//   block nb, K tile kt) one 8 KB chunk, where thread (warpgroup c, warp w,
//   lane g*4+t) finds its 32 bytes of the tile as two 16-byte pieces 512
//   bytes apart; in each 8 bytes of a k16 step, the A registers 0..3 hold
//   (column 64c+16w+g, k 2t..2t+1), (column +8, k 2t..), (column, k 2t+8..),
//   (column +8, k 2t+8..).  The plain version is ref.pack_fragments.  Ragged
//   K and N are zero-padded there, to whole tiles.
// - The ring.  WSTAGES stages of (x tile 256 x 64 bf16 = 32 KB, one TMA box
//   with the 128-byte swizzle; weight chunk 8 KB, one bulk copy).  One
//   thread of the producer fills them, each completing on its stage's full
//   mbarrier (expect_tx bytes), after waiting on its empty mbarrier, which
//   every consumer warp arrives at once its products of the stage retire.
//   Producer and consumers count stages over all of the CTA's tiles, which
//   gives each wait its parity.  x rows past M and columns past K load as
//   zeros.
// - The consumers (setmaxnreg 240; the producer gives up to 24) own 64
//   weight columns x 256 x rows each: 128 f32 accumulators a thread.  Per
//   stage a thread reads its 32 bytes with two 16-byte loads
//   (conflict-free: a warp reads 512 contiguous bytes), widens them to 16
//   bf16 pairs in registers (widen: exact), and issues four wgmma
//   m64n256k16 with A from registers and B from the x tile.  The next
//   stage is widened while this stage's products and those of the stage
//   before are in flight, so the widening stays off the tensor cores'
//   path; the A registers rotate through three sets, each rewritten only
//   after the group that read it retired.  (Widening between the groups,
//   with two sets, measured slower.)
// - The epilogue applies scale[n] (one value per accumulator row) in f32,
//   casts to bf16, writes the warpgroup's [256 x 64] tile of out into shared
//   memory with the 128-byte swizzle (the transpose: accumulator row n
//   becomes a column; conflict-free) and stores it with one TMA box; the
//   2-D map clips rows past M and columns past N.  The next tile's writes
//   into that staging tile wait until the store has read it.
// Where trouble is likely, and what the code does about it:
// - The A fragment's order is written once on each side (pack_fragments
//   here, ref.fragment_order in Python), and the card tests hold this pass
//   against the plain version byte for byte.
// - A wrong parity on a full or empty barrier would show as run-to-run
//   differences: the card tests compare calls bit for bit.
// - The A registers of an in-flight group must not be reused.  In C++ each
//   set is rewritten only after the wgmma.wait_group that retires the group
//   reading it; ptxas, though, frees them as soon as the wgmma issues (the
//   SASS of a first version gave one set's registers to the widening of the
//   next while the group still ran, and the results went wrong), so each
//   set's values are used once more after that wait (keep_until_here).
// - TMA needs 16-byte aligned bases and row strides that are multiples of
//   16 bytes (K % 8 == 0 for x, N % 8 == 0 for out), and pack_fragments
//   reads w_q in 16-byte pieces (N % 16 == 0): wgmma_ready refuses the rest,
//   which the caller routes to w8a16_mma.
// ---------------------------------------------------------------------------
constexpr int TN = 128;                  // weight columns per CTA
constexpr int TM = 256;                  // x rows per CTA
constexpr int TK = 64;                   // K per stage: one 128-byte box
constexpr int WSTAGES = 4;               // ring depth
constexpr int WG_THREADS = 128;
constexpr int PACK_THREADS = TN * TK / 16;  // one 16-byte piece each
constexpr int X_STAGE = TM * TK * 2;        // 32 KB
constexpr int W_STAGE = TN * TK;            // 8 KB, packed int8
constexpr int OUT_HALF = TM * 64 * 2;      // a consumer's out tile
constexpr int W_OFF = WSTAGES * X_STAGE;
constexpr int OUT_OFF = W_OFF + WSTAGES * W_STAGE;
constexpr int BAR_OFF = OUT_OFF + 2 * OUT_HALF;
// full, then empty per stage; 1024 bytes of slack to align the base to
// the swizzle's period
constexpr int WGMMA_SMEM = BAR_OFF + 8 * 2 * WSTAGES + 1024;
static_assert(WGMMA_SMEM <= 232448, "w8a16_wgmma: shared memory");

// The weight in fragment order: thread `tid` of block (kt, nb) writes the
// 16 bytes at offset 16 tid of chunk nb * nk + kt (ref.fragment_order).
__global__ void __launch_bounds__(PACK_THREADS)
    pack_fragments(const int8_t* __restrict__ w, int8_t* __restrict__ wp,
                   int K, int N, int nk) {
  // 64 rows of 128 bytes, padded to 132: the reads below hit 8 banks
  __shared__ __align__(16) uint32_t tile[TK][(TN + 4) / 4];
  const int kt = blockIdx.x, nb = blockIdx.y, tid = threadIdx.x;
  {
    const int r = tid / 8, col = (tid % 8) * 16;
    const int k = kt * TK + r, n = nb * TN + col;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < K && n < N)  // N % 16 == 0: the 16 bytes lie inside the row
      v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + n));
    uint32_t* dst = &tile[r][col / 4];
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(tile);
  const int lane = tid % 32, h = tid / 32 % 2, warp = tid / 64 % 4;
  const int c = tid / 256, g = lane / 4, t = lane % 4;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int s = 2 * h + j / 8, b = j % 8, r = b / 2;
    const int n = 64 * c + 16 * warp + g + 8 * (r & 1);
    const int k = 16 * s + 2 * t + (b & 1) + 8 * (r >> 1);
    out[j / 4] |= (uint32_t)bytes[k * (TN + 4) + n] << (8 * (j % 4));
  }
  *reinterpret_cast<uint4*>(wp + ((size_t)nb * nk + kt) * W_STAGE +
                            16 * tid) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// Four int8 (one word) to two bf16 pairs, lo = (b0, b1), hi = (b2, b3),
// exactly: byte v becomes the f32 2^23 + (v + 128) by placing v ^ 0x80 under
// 2^23's exponent, minus 2^23 + 128 gives v, and the upper half of that f32
// is its bf16 (an integer of at most 8 significant bits).
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__fadd_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)),
        -8388736.0f));
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// d[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(3 * WG_THREADS, 1)
    w8a16_wgmma(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap out_map,
                const int8_t* __restrict__ wp,
                const float* __restrict__ scale, int N, int nk, int nbl,
                int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  auto full = [&](int s) { return sbase + BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return sbase + BAR_OFF + 8 * (WSTAGES + s); };
  auto x_tile = [&](int s) { return sbase + s * X_STAGE; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG_THREADS / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // stages filled, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / nbl * TM;
        const int8_t* w_src = wp + (size_t)(tile % nbl) * nk * W_STAGE;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % WSTAGES;
          mbar_wait(empty(s), ((it / WSTAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), X_STAGE + W_STAGE);
          tma_load(x_tile(s), &x_map, full(s), kt * TK, m0);
          bulk_load(sbase + W_OFF + s * W_STAGE,
                    w_src + (size_t)kt * W_STAGE, W_STAGE, full(s));
        }
      }
    }
    return;
  }

  // ---- consumers: 64 weight columns x 256 x rows each -----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // this thread's 32 bytes of a weight chunk: two 16-byte pieces
  const int a_off = (c * 4 + warp) * 1024 + lane * 16;

  float acc[128];
  // A of k16 steps 0..3 in three sets, in turn: the stage in the tensor
  // cores, the stage before it (still in flight), and the next one, widened
  // meanwhile
  uint32_t a0[4][4], a1[4][4], a2[4][4];
  int it = 0;  // stages taken, over all of this CTA's tiles

  // wait for stage `i` and widen this thread's weight bytes of it into `a`
  auto widen_stage = [&](int i, uint32_t (&a)[4][4]) {
    const int s = i % WSTAGES;
    mbar_wait(full(s), (i / WSTAGES) & 1);
    const unsigned char* wb = smem + W_OFF + s * W_STAGE + a_off;
    const uint4 p0 = *reinterpret_cast<const uint4*>(wb);        // steps 0, 1
    const uint4 p1 = *reinterpret_cast<const uint4*>(wb + 512);  // steps 2, 3
    widen(p0.x, a[0][0], a[0][1]);
    widen(p0.y, a[0][2], a[0][3]);
    widen(p0.z, a[1][0], a[1][1]);
    widen(p0.w, a[1][2], a[1][3]);
    widen(p1.x, a[2][0], a[2][1]);
    widen(p1.y, a[2][2], a[2][3]);
    widen(p1.z, a[3][0], a[3][1]);
    widen(p1.w, a[3][2], a[3][3]);
  };
  // K tile kt of nk (stage `it`, widened into `a`): start its four
  // products, widen the next stage into `next` while they and the stage
  // before run, then retire the stage before (A set `prev`) and hand its
  // slot back to the producer
  auto stage = [&](int kt, int nk_, uint32_t (&a)[4][4],
                   uint32_t (&next)[4][4], uint32_t (&prev)[4][4]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      // 16 columns of K a step: 32 bytes inside the 128-byte swizzled row
      wgmma_rs_n256(acc, a[kk],
                    sw128_desc(x_tile(it % WSTAGES) + kk * 32, 16, 1024));
    wgmma_commit();
    if (kt + 1 < nk_) widen_stage(it + 1, next);
    wgmma_wait<1>();  // the products of the stage before
    reg_fence(acc);
    keep_until_here(prev, N < 0, smem);
    if (kt > 0 && lane == 0) mbar_arrive(empty((it - 1) % WSTAGES));
    ++it;
  };

  const int col = 16 * warp + g;  // this thread's columns: col, col + 8
  unsigned char* ob = smem + OUT_OFF + c * OUT_HALF;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % nbl * TN, m0 = tile / nbl * TM;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    widen_stage(it, a0);
    for (int kt = 0; kt < nk; kt += 3) {
      stage(kt, nk, a0, a1, a2);
      if (kt + 1 < nk) stage(kt + 1, nk, a1, a2, a0);
      if (kt + 2 < nk) stage(kt + 2, nk, a2, a0, a1);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    keep_until_here(a0, N < 0, smem);
    keep_until_here(a1, N < 0, smem);
    keep_until_here(a2, N < 0, smem);
    if (lane == 0) mbar_arrive(empty((it - 1) % WSTAGES));  // the last one

    // ---- epilogue: scale, bf16, transposed into shared memory, TMA store
    const int nc = n0 + 64 * c + col;
    const float sc[2] = {nc < N ? scale[nc] : 0.f,
                         nc + 8 < N ? scale[nc + 8] : 0.f};
    // the previous tile's store has read the staging tile
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "r"(WG_THREADS)
                 : "memory");
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator (row col + 8 (e / 2), column 8j + 2t + e % 2) is
        // out[m0 + m][n0 + 64c + cc]: row m of the tile, 16-byte chunk
        // cc / 8 swizzled by m % 8
        const int m = 8 * j + 2 * t + (e & 1), cc = col + 8 * (e >> 1);
        *reinterpret_cast<__nv_bfloat16*>(
            ob + m * 128 + (((cc / 8) ^ (m % 8)) * 16) + (cc % 8) * 2) =
            __float2bfloat16(acc[4 * j + e] * sc[e >> 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "r"(WG_THREADS)
                 : "memory");
    if (tid == 0 && n0 + 64 * c < N) {
      tma_store(&out_map, smem_u32(ob), n0 + 64 * c, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// A 2-D bf16 map over a row-major [rows, cols] matrix, boxes of 64 columns
// x TM rows, 128-byte swizzle, zero fill past the edges.
int encode_2d(EncodeTiled encode, CUtensorMap* map, const void* base,
              int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, TM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// What w8a16_wgmma and pack_fragments need: 16-byte aligned bases, x and
// out rows a multiple of 16 bytes (TMA), w_q rows of whole 16-byte pieces.
bool wgmma_ready(const void* x, const void* w, const void* out, int n,
                 int k) {
  const void* ptrs[3] = {x, w, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return k % 8 == 0 && n % 16 == 0;
}

// Bytes of the weight in fragment order: whole 64 x 128 tiles.
long long packed_bytes(int n, int k) {
  return (long long)cdiv(n, TN) * cdiv(k, TK) * W_STAGE;
}

// nk K tiles of w into wp, one chunk per (column block, K tile).
int pack_weight(const void* w, void* wp, int n, int k, int nk,
                cudaStream_t stream) {
  const int nbl = cdiv(n, TN);
  if (nbl > 65535) return (int)cudaErrorInvalidValue;
  pack_fragments<<<dim3(nk, nbl), PACK_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wp), k, n, nk);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const void* w, const float* scale, void* out,
                 void* wp, int m, int n, int k, cudaStream_t stream) {
  const int nk = cdiv(k, TK);  // a ragged last K tile loads as zeros
  // the shared-memory limit is raised once per device, not per launch
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(w8a16_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WGMMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised |= 1u << dev;
  }
  EncodeTiled encode;
  int rc = get_encoder(&encode);
  CUtensorMap maps[2];
  if (!rc) rc = encode_2d(encode, &maps[0], x, m, k);
  if (!rc) rc = encode_2d(encode, &maps[1], out, m, n);
  if (!rc) rc = pack_weight(w, wp, n, k, nk, stream);
  if (rc) return rc;
  // one CTA per SM at most, each walking tiles blockIdx.x, + gridDim.x, ...
  // (the weight's column blocks innermost, so the CTAs in flight share
  // their x rows in L2)
  const int nbl = cdiv(n, TN);
  const long long tiles = (long long)nbl * cdiv(m, TM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  w8a16_wgmma<<<(unsigned)std::min<long long>(tiles, sms), 3 * WG_THREADS,
                WGMMA_SMEM, stream>>>(maps[0], maps[1],
                                      static_cast<const int8_t*>(wp), scale,
                                      n, nk, nbl, (int)tiles);
  return (int)cudaGetLastError();
}

// The routes, by the number the caller passes (kernel.py, ROUTES).
enum Route { kF32 = 0, kMma = 1, kWgmma = 2 };

// The tiling of a call of the two split-K routes: output tile (bm x bn),
// K tile, and the split of K.
struct Plan {
  int bm, bn, bk, nk, kt_per, splits;
};

// Splits of K so that the card holds about four blocks per SM: only where
// the output tiles alone fall short, never more than the K tiles.
int make_plan(int m, int n, int k, int route, Plan* p) {
  if (route == kMma) {
    p->bm = m <= 16 ? 16 : 128;
    p->bn = 128;
    p->bk = 64;
  } else {
    p->bm = FM;
    p->bn = FN;
    p->bk = FK;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  p->nk = k_tiles(k, p->bk);
  const long long tiles = (long long)cdiv(m, p->bm) * cdiv(n, p->bn);
  int s = 1;
  if (p->nk > 1 && tiles < 4LL * sms)
    s = std::min(cdiv(4LL * sms, tiles), p->nk);
  p->kt_per = p->nk > 0 ? cdiv(p->nk, s) : 1;
  p->splits = p->nk > 0 ? cdiv(p->nk, p->kt_per) : 1;
  return 0;
}

template <int BM, int BN, int BK, int WM_, int WN_>
void launch_mma(const void* x, const void* w, const float* scale, void* out,
                float* ws, int m, int n, int k, const Plan& p,
                cudaStream_t stream) {
  const bool vec_x = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid(cdiv(n, BN), cdiv(m, BM), p.splits);
  w8a16_mma<BM, BN, BK, WM_, WN_><<<grid, 32 * WM_ * WN_, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      scale, static_cast<__nv_bfloat16*>(out), p.splits > 1 ? ws : nullptr,
      m, n, k, p.nk, p.kt_per, vec_x, vec_w);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  if (code >= kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of workspace a call of this shape and route takes: w8a16_wgmma's
// weight in fragment order, or the split-K routes' splits x M x N f32 when
// K is split (0 otherwise); a negative cudaError_t on failure.  route 0 =
// w8a16_f32, 1 = w8a16_mma, 2 = w8a16_wgmma.
long long int8_matmul_workspace(int m, int n, int k, int route) {
  if (route == kWgmma) return packed_bytes(n, k);
  Plan p;
  const int err = make_plan(m, n, k, route, &p);
  if (err) return -(long long)err;
  return p.splits > 1 ? 4LL * p.splits * m * n : 0;
}

// w [K,N] int8 into w8a16_wgmma's fragment order (ref.pack_fragments):
// wp holds int8_matmul_workspace(., n, k, 2) bytes; w 16-byte aligned, N %
// 16 == 0.  Returns the launch's cudaError_t.
int int8_matmul_pack(const void* w, void* wp, int n, int k, void* stream) {
  if (n < 1 || k < 1 || n % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return pack_weight(w, wp, n, k, cdiv(k, TK),
                     static_cast<cudaStream_t>(stream));
}

// x [M,K] (f32 or bf16, dtype 0 or 1), w [K,N] int8, scale [N] f32, out
// [M,N] in x's type, all contiguous, on the given route (f32 x takes route
// 0, bf16 x route 1 or 2; route 2 only where wgmma_ready); ws:
// int8_matmul_workspace(...) bytes, unused when that is 0.  M, N, K >= 1.
// Returns the launches' cudaError_t, or kEncodeFailed + a CUresult.
int int8_matmul(const void* x, const void* w, const void* scale, void* out,
                void* ws, int dtype, int m, int n, int k, int route,
                void* stream) {
  if (m < 1 || n < 1 || k < 1 || (route == kF32) != (dtype == 0) ||
      (dtype != 0 && dtype != 1) || route < kF32 || route > kWgmma ||
      (route == kWgmma && !wgmma_ready(x, w, out, n, k)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (route == kWgmma) return launch_wgmma(x, w, sc, out, ws, m, n, k, s);
  Plan p;
  const int err = make_plan(m, n, k, route, &p);
  if (err) return err;
  if (cdiv(m, p.bm) > 65535 || p.splits > 65535)
    return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  if (route == kMma && p.bm == 16)
    launch_mma<16, 128, 64, 1, 4>(x, w, sc, out, wsf, m, n, k, p, s);
  else if (route == kMma)
    launch_mma<128, 128, 64, 2, 4>(x, w, sc, out, wsf, m, n, k, p, s);
  else
    w8a16_f32<<<dim3(cdiv(n, FN), cdiv(m, FM), p.splits), FT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w), sc,
        static_cast<float*>(out), p.splits > 1 ? wsf : nullptr, m, n, k,
        p.nk, p.kt_per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  const long long mn = (long long)m * n;
  const int blocks = std::min(cdiv(mn, 256), 4096);
  if (dtype == 1)
    reduce_splits<<<blocks, 256, 0, s>>>(wsf, sc,
                                         static_cast<__nv_bfloat16*>(out), m,
                                         n, p.splits);
  else
    reduce_splits<<<blocks, 256, 0, s>>>(wsf, sc, static_cast<float*>(out),
                                         m, n, p.splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
