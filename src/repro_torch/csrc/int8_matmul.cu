// W8A16 matmul: out[M,N] = (x[M,K] · f32(w_q[K,N])) * scale[N], in x's
// type, with int8 weights and a per-output-channel f32 scale.
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py, int8_matmul_kernel
// (the Pallas TPU kernel, body _kernel), whose grid (M/bm, N/bn, K/bk) runs
// K innermost, keeps an f32 accumulator in VMEM scratch across the K steps
// and applies the scale once at the last one.  Its wrapper pads every
// operand to whole tiles; here the kernels mask the ragged edges
// themselves, so no padded copy of the weight is made.
//
// What bounds it on the H100: at decode (M <= 16) bytes: every weight byte
// is read once and used by only M rows, so the int8 weight (half of a bf16
// one) sets the time.  At prefill (M in the thousands) operations.
//
// Two kernels, one function:
// - bf16 x: w8a16_mma, tensor cores (mma.sync m16n8k16, f32 accumulate).
//   The int8 tile is read from device memory as int8 and widened to bf16
//   (exact for -127..127) as it is stored to shared memory, in a
//   pair-interleaved layout: word (kp, n) holds bf16(w[2kp][n]) in its low
//   half and bf16(w[2kp+1][n]) in its high half, which is exactly the pair
//   the B fragment wants (k = 2t, 2t+1 of column g).  The store is four
//   16-byte writes per (2 rows x 16 columns) chunk and the fragment reads
//   are conflict-free (row stride = 8 mod 32 words).  The next K tile is
//   loaded into registers while the tensor cores work on this one.  Two
//   tilings: 16 x 128 x 64 with 4 warps for M <= 16 (decode), 128 x 128 x 64
//   with 8 warps otherwise.
// - f32 x: w8a16_f32, CUDA cores, FFMA in f32 throughout (no TF32, which
//   keeps 10 mantissa bits), 64 x 64 x 32 tiles, 16 outputs a thread.
// Both: where the output tiles alone leave the card short of blocks
// (decode's 16 to 48 tiles on 132 SMs), K is split over blockIdx.z into
// contiguous runs of tiles; each split writes its f32 partial sums to a
// workspace and reduce_splits adds them in split order (deterministic, no
// float atomics), then scales and casts.  One split scales and casts in
// the kernel's own epilogue.  16-byte loads are taken only where every row
// start is 16-byte aligned (K % 8 == 0 for x, N % 16 == 0 for w); other
// shapes load element by element, zero-filled past M, N and K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// The tiling of a call: output tile (bm x bn), K tile, and the split of K.
struct Plan {
  int bm, bn, bk, nk, kt_per, splits;
};

// Splits of K so that the card holds about four blocks per SM: only where
// the output tiles alone fall short, never more than the K tiles.
int make_plan(int m, int n, int k, int dtype, Plan* p) {
  if (dtype == 1) {
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

template <int BM, int BN, int BK, int WM, int WN>
void launch_mma(const void* x, const void* w, const float* scale, void* out,
                float* ws, int m, int n, int k, const Plan& p,
                cudaStream_t stream) {
  const bool vec_x = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid(cdiv(n, BN), cdiv(m, BM), p.splits);
  w8a16_mma<BM, BN, BK, WM, WN><<<grid, 32 * WM * WN, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      scale, static_cast<__nv_bfloat16*>(out), p.splits > 1 ? ws : nullptr,
      m, n, k, p.nk, p.kt_per, vec_x, vec_w);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// How many splits of K a call of this shape takes (the workspace the
// caller passes holds splits x M x N f32 when that is above 1), or a
// negative cudaError_t.  dtype 0 = f32 x, 1 = bf16 x.
int int8_matmul_splits(int m, int n, int k, int dtype) {
  Plan p;
  const int err = make_plan(m, n, k, dtype, &p);
  return err ? -err : p.splits;
}

// x [M,K] (f32 or bf16, dtype 0 or 1), w [K,N] int8, scale [N] f32, out
// [M,N] in x's type, all contiguous; ws: int8_matmul_splits(...) x M x N
// f32 when that is above 1, else unused.  M, N, K >= 1.  Returns the
// launches' cudaError_t.
int int8_matmul(const void* x, const void* w, const void* scale, void* out,
                void* ws, int dtype, int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(m, n, k, dtype, &p);
  if (err) return err;
  if (cdiv(m, p.bm) > 65535 || p.splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 1 && p.bm == 16)
    launch_mma<16, 128, 64, 1, 4>(x, w, sc, out, wsf, m, n, k, p, s);
  else if (dtype == 1)
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
