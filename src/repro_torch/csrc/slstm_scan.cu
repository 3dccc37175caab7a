// The sLSTM recurrence of xLSTM's scalar-memory block over a whole
// sequence: per step, each gate's pre-activation plus the block-diagonal
// recurrent product of the step before's h, then the stabilised cell.
//
// Replaces: src/repro/models/xlstm.py, slstm_scan (not a Pallas kernel: a
// lax.scan that XLA runs on the accelerator), the recurrence of every sLSTM
// block's prefill (xlstm-350m: 6 of its 24 blocks).
//
// The function, for head hd of H, unit v of du (d = H du), step t of S:
//   g[k, b, v] = pre[k, b, t, hd du + v] + sum_u h[b, hd du + u] R[k, hd, u, v]
//   z = tanh(g_z), i = g_i, f = g_f, o = sigmoid(g_o)
//   lf = log_sigmoid(f) = min(f, 0) - log1p(exp(-|f|))
//   m' = max(lf + m, i), c = e^(lf+m-m') c + e^(i-m') z,
//   n = e^(lf+m-m') n + e^(i-m'), h = o c / max(n, 1e-6)
// from c = n = h = m = 0 (src/repro/models/xlstm.py:176-191).  R is widened
// to f32 before the product, as the reference's einsum promotes it; the
// gates, the state and the sums are f32.  Never build with
// --use_fast_math: expf, log1pf and tanhf are the accurate ones.
//
// What bounds it on the H100: the chain of S dependent steps.  The work
// is 2 B S 4 H du^2 operations (17.2 GFLOP at xlstm-350m's B 4, S 2048,
// H 4, du 256: 0.257 ms at 67 TFLOP/s f32) and pre's 4 B S d f32 (134 MB,
// 0.040 ms at 3.35 TB/s); but no step can start before the one before has
// written h, so the time is S times one step's latency.
//
// Two routes, chosen by shape (kernels/slstm_scan/kernel.py:choose_route).
//
// Route "cluster": one thread-block cluster of CS = 8 CTAs per head (the
// portable size), launched with cudaLaunchKernelEx.  CTA c of a head
// owns units [c U, (c+1) U), U = du / CS, for all four gates, so the cell of
// every unit it owns is local to it.
//  - R stays in shared memory for the whole sequence: at start each CTA
//    copies its slice, R[k, hd, u, v] for its U units v, in R's own dtype,
//    as rs[v][u][k] (a unit's row padded to 64 bytes past a multiple of
//    128, so two lane groups of one warp read disjoint banks).  At du 256
//    that is 64 KiB in bf16 and 128 KiB in f32 at CS 8.
//  - Each CTA keeps the whole head's h, [du][4 nb] f32 (nb = ceil(B/4)
//    blocks of four rows, the missing rows zero), twice: step t reads slot
//    t % 2 and writes the new h of each unit it owns into slot (t+1) % 2
//    of every CTA of the cluster (mapa + st.shared::cluster), then meets
//    one cluster barrier (arrive.release / wait.acquire).  With the double
//    buffer that one barrier is all the step needs: a CTA writes a slot
//    only after every CTA has passed the barrier that ended its reads of
//    it.  There is no other barrier on the chain.
//  - A lane group of LG = 8 lanes owns (unit v, row block): its lanes split
//    u (lane q takes u = q, q + LG, ...), each summing the 16 products of
//    its four rows and four gates in a fixed order; a butterfly over the
//    group (two halving exchanges, then one full one) leaves both lanes of
//    the group's row q / 2 with that row's four gate sums, the same bits on
//    each.  Those lanes add pre and apply the cell; c, n, m and h stay in
//    their registers, and the two of them share the CS remote stores.  So
//    the sums are deterministic: two calls give the same bits.
//  - pre leaves the chain: a lane's four pre values of step t + 1 are
//    loaded while step t runs.  h goes to h_out between the arrive and the
//    wait, and c, n, h, m to their outputs once, at the end.
// CS 8 and 8 lanes a unit's sums (du threads a CTA up to B 4), the one
// plan the route has: at xlstm-350m's prefill on an H100 a step takes
// ~2.3 us (4.71 ms a call in bf16, 5.02 in f32) against 5.02 ms at 8 CTAs
// x 16 lanes, 5.39 at 8 x 4, 6.65 at 4 x 8 and 6.99 at 4 x 4 (PERF.md):
// half the products a CTA outweighs twice the remote stores, and 8 lanes
// balance a lane's sums against the cells and shuffles of more warps.
// Every served shape takes it; the block route takes 50.8 ms at that
// shape in the same run.
//
// Route "block", the first design, for the shapes the cluster route does
// not take: one block per head, 4 du threads: thread (k, v) owns gate k of
// unit v.  Each step it reads column v of R[k, hd] (neighbouring threads
// read neighbouring v: coalesced; the whole R, 2 MB in bf16 at
// xlstm-350m's width, stays in L2 across steps) once for every 4 batch
// rows, and h of those rows from shared memory (one address a warp: a
// broadcast).  A barrier; then threads (b, v) apply the cell to the
// head's B du units, keeping c, n and m in shared memory, and write h to
// shared memory and to the output.  A second barrier ends the step.  So
// every step streams the head's 4 du^2 R entries from L2 into one SM: ~25
// us a step on an H100 at xlstm-350m's shape in bf16 and in f32 alike
// (chip_smoke.py), however its loads are shaped; the step waits on its R
// reads from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_UNITS = 256;        // 4 du threads a block, at most 1024
constexpr int BATCH_GROUP = 4;        // batch rows a gate thread sums at once
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int CLUSTER_THREADS = 512;  // a CTA of the cluster route, at most
constexpr int CS = 8;                 // CTAs a cluster: the portable size
constexpr int LG = 8;                 // lanes that split a unit's sums
constexpr int ROWS = 4;               // batch rows a lane group holds
constexpr int REG_UNITS = 32;         // the backward's R rows in registers
constexpr int REG_THREADS = 256;      // its CTA: a thread per u at du 256

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// what the forward keeps for the backward when asked: save [8][B][S][d],
// planes c, n, m, h (the state after the step), z, i, f, o (the gates: z
// and o activated, i and f as they entered the cell)
__device__ __forceinline__ void save_step(float* save, size_t plane,
                                          size_t at, float c, float n,
                                          float m, float h, float z, float i,
                                          float f, float o) {
  const float v[8] = {c, n, m, h, z, i, f, o};
#pragma unroll
  for (int k = 0; k < 8; ++k) save[k * plane + at] = v[k];
}

// pre [4, B, S, d] f32; r [4, H, du, du]; h_out [B, S, d]; the final
// c, n, h, m [B, d] f32.  Grid H blocks of 4 du threads; shared memory
// 8 B du floats: h [B][du], the gates [4][B][du], c, n, m [B][du].
template <typename TR, typename TO>
__global__ void __launch_bounds__(4 * MAX_UNITS) slstm_scan_kernel(
    const float* __restrict__ pre, const TR* __restrict__ r,
    TO* __restrict__ h_out, float* __restrict__ c_out,
    float* __restrict__ n_out, float* __restrict__ hl_out,
    float* __restrict__ m_out, float* __restrict__ save, int B, int S,
    int H, int du) {
  extern __shared__ float smem[];
  const int d = H * du, bu = B * du;
  float* hs = smem;
  float* gs = hs + bu;
  float* cs = gs + 4 * bu;
  float* ns = cs + bu;
  float* ms = ns + bu;
  const int head = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int gate = tid / du, v = tid - gate * du;
  for (int i = tid; i < 8 * bu; i += nt) smem[i] = 0.f;
  __syncthreads();
  // column v of R[gate, head]: entry u at rcol[u du]
  const TR* rcol = r + ((size_t)gate * H + head) * du * du + v;
  // pre[gate, b, t, head du + v] at pcol[(b S + t) d]
  const float* pcol = pre + (size_t)gate * B * S * d + head * du + v;
  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += BATCH_GROUP) {
      const int nb = min(BATCH_GROUP, B - b0);
      float p[BATCH_GROUP], acc[BATCH_GROUP];
#pragma unroll
      for (int j = 0; j < BATCH_GROUP; ++j) {
        // issued before the product, used after it
        p[j] = j < nb ? __ldg(pcol + ((size_t)(b0 + j) * S + t) * d) : 0.f;
        acc[j] = 0.f;
      }
      const float* hrow = hs + b0 * du;
#pragma unroll 8
      for (int u = 0; u < du; ++u) {
        const float w = widen(rcol[(size_t)u * du]);
#pragma unroll
        for (int j = 0; j < BATCH_GROUP; ++j)
          if (j < nb) acc[j] = fmaf(hrow[j * du + u], w, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < BATCH_GROUP; ++j)
        if (j < nb) gs[(gate * B + b0 + j) * du + v] = p[j] + acc[j];
    }
    __syncthreads();
    for (int i = tid; i < bu; i += nt) {
      const int b = i / du, u = i - b * du;
      const float zt = tanhf(gs[i]);
      const float it = gs[bu + i];
      const float lf = log_sigmoid(gs[2 * bu + i]);
      const float ot = 1.f / (1.f + expf(-gs[3 * bu + i]));
      const float m = ms[i];
      const float mn = fmaxf(lf + m, it);
      const float ip = expf(it - mn);
      const float fp = expf(lf + m - mn);
      const float c = fp * cs[i] + ip * zt;
      const float n = fp * ns[i] + ip;
      const float h = ot * c / fmaxf(n, 1e-6f);
      cs[i] = c;
      ns[i] = n;
      ms[i] = mn;
      hs[i] = h;
      const size_t at = ((size_t)b * S + t) * d + head * du + u;
      put(h_out + at, h);
      if (save) save_step(save, (size_t)B * S * d, at, c, n, mn, h, zt, it,
                          gs[2 * bu + i], ot);
    }
    __syncthreads();
  }
  for (int i = tid; i < bu; i += nt) {
    const int b = i / du, u = i - b * du;
    const size_t o = (size_t)b * d + head * du + u;
    c_out[o] = cs[i];
    n_out[o] = ns[i];
    hl_out[o] = hs[i];
    m_out[o] = ms[i];
  }
}

template <typename TR, typename TO>
int launch(const float* pre, const void* r, void* h_out, float* c_out,
           float* n_out, float* hl_out, float* m_out, float* save, int B,
           int S, int H, int du, size_t smem, cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<TR, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<H, 4 * du, smem, stream>>>(
      pre, static_cast<const TR*>(r), static_cast<TO*>(h_out), c_out, n_out,
      hl_out, m_out, save, B, S, H, du);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// route "cluster"

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// the address of this CTA's shared-memory word `addr` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void store_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(x)
               : "memory");
}

// the four gates of one unit at one u, widened to f32
__device__ __forceinline__ void gates4(const float* p, float* w) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}
__device__ __forceinline__ void gates4(const __nv_bfloat16* p, float* w) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(x.x << 16);
  w[1] = __uint_as_float(x.x & 0xffff0000u);
  w[2] = __uint_as_float(x.y << 16);
  w[3] = __uint_as_float(x.y & 0xffff0000u);
}

// four gates of R as one load, and widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void widen4(float4 x, float* w) {
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}
__device__ __forceinline__ void widen4(uint2 x, float* w) {
  w[0] = __uint_as_float(x.x << 16);
  w[1] = __uint_as_float(x.x & 0xffff0000u);
  w[2] = __uint_as_float(x.y << 16);
  w[3] = __uint_as_float(x.y & 0xffff0000u);
}

// elements of a unit's row of the R slice: du u's of 4 gates, padded so the
// row is 64 bytes past a multiple of 128
__host__ __device__ __forceinline__ int r_stride(int du, int el) {
  const int bytes = 4 * du * el;
  return (bytes + (64 - bytes % 128 + 128) % 128) / el;
}

// shared memory of the cluster route: h twice, then the R slice
__host__ __device__ __forceinline__ size_t cluster_smem(int B, int du,
                                                        int units, int el) {
  const int nb = (B + ROWS - 1) / ROWS;
  return sizeof(float) * 2 * (size_t)du * ROWS * nb
         + (size_t)units * r_stride(du, el) * el;
}

// pre [4, B, S, d] f32; r [4, H, du, du]; h_out [B, S, d]; the final c, n,
// h, m [B, d] f32.  Grid H CS CTAs in clusters of CS, `units` = du / CS
// units a CTA, units nb LG threads a CTA.
template <typename TR, typename TO>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1) slstm_scan_cluster(
    const float* __restrict__ pre, const TR* __restrict__ r,
    TO* __restrict__ h_out, float* __restrict__ c_out,
    float* __restrict__ n_out, float* __restrict__ hl_out,
    float* __restrict__ m_out, float* __restrict__ save, int B, int S,
    int H, int du, int units) {
  constexpr int SUBS = LG / 4;        // lanes that share a row's cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = (B + ROWS - 1) / ROWS, hrow = ROWS * nb, d = H * du;
  const int slot = du * hrow;                     // floats of one h slot
  float* hbuf = reinterpret_cast<float*>(smem_raw);   // [2][du][hrow]
  TR* rs = reinterpret_cast<TR*>(hbuf + 2 * slot);    // [units][rstride]
  const int rstride = r_stride(du, (int)sizeof(TR));
  const unsigned rank = cluster_rank();
  const int head = blockIdx.x / CS, tid = threadIdx.x, nt = blockDim.x;
  const int task = tid / LG, q = tid % LG;
  const int unit = task % units, rb = task / units;
  const int v = (int)rank * units + unit;         // the unit in the head
  const int row = q / SUBS, sub = q % SUBS;
  const int b = rb * ROWS + row;
  const bool live = b < B;

  for (int i = tid; i < 2 * slot; i += nt) hbuf[i] = 0.f;
  for (int i = tid; i < 4 * du * units; i += nt) {
    const int w = i % units, gu = i / units, u = gu % du, k = gu / du;
    rs[w * rstride + u * 4 + k] =
        r[((size_t)(k * H + head) * du + u) * du + rank * units + w];
  }
  cluster_arrive();          // every CTA's h zeroed before any remote store
  cluster_wait();

  // pre[k, b, t, head du + v] at pcol[k gstride + t d]
  const size_t gstride = (size_t)B * S * d;
  const float* pcol = pre + (size_t)(live ? b : 0) * S * d + head * du + v;
  const TR* rrow = rs + unit * rstride;
  const uint32_t hbase = (uint32_t)__cvta_generic_to_shared(hbuf)
                         + (uint32_t)(sizeof(float) * (v * hrow + b));
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f, p_next[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    p_next[k] = live ? __ldg(pcol + k * gstride) : 0.f;
  for (int t = 0; t < S; ++t) {
    float p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = p_next[k];
      // issued now, used a step later: pre is off the chain
      if (live && t + 1 < S)
        p_next[k] = __ldg(pcol + k * gstride + (size_t)(t + 1) * d);
    }
    // acc[4 j + k]: gate k of row j of the block, over this lane's u
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const float* hs = hbuf + (t & 1) * slot + rb * ROWS;
#pragma unroll 4
    for (int u = q; u < du; u += LG) {
      const float4 hv = *reinterpret_cast<const float4*>(hs + u * hrow);
      float w[4];
      gates4(rrow + u * 4, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k] = fmaf(hv.x, w[k], acc[k]);
        acc[4 + k] = fmaf(hv.y, w[k], acc[4 + k]);
        acc[8 + k] = fmaf(hv.z, w[k], acc[8 + k]);
        acc[12 + k] = fmaf(hv.w, w[k], acc[12 + k]);
      }
    }
    // halve twice: rows 0-1 | 2-3, then one row of each pair
    {
      const bool up = q & (LG / 2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float send = up ? acc[i] : acc[i + 8];
        const float keep = up ? acc[i + 8] : acc[i];
        acc[i] = keep + __shfl_xor_sync(FULL, send, LG / 2);
      }
    }
    {
      const bool up = q & (LG / 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float send = up ? acc[i] : acc[i + 4];
        const float keep = up ? acc[i + 4] : acc[i];
        acc[i] = keep + __shfl_xor_sync(FULL, send, LG / 4);
      }
    }
    // then sum over the SUBS lanes of the row: the same bits on each
#pragma unroll
    for (int o = SUBS / 2; o >= 1; o >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] += __shfl_xor_sync(FULL, acc[i], o);
    const float zt = tanhf(p[0] + acc[0]);
    const float it = p[1] + acc[1];
    const float lf = log_sigmoid(p[2] + acc[2]);
    const float ot = 1.f / (1.f + expf(-(p[3] + acc[3])));
    const float mn = fmaxf(lf + m, it);
    const float ip = expf(it - mn);
    const float fp = expf(lf + m - mn);
    c = fp * c + ip * zt;
    n = fp * n + ip;
    h = ot * c / fmaxf(n, 1e-6f);
    m = mn;
    if (live) {
      const uint32_t dst = hbase + (uint32_t)(sizeof(float) * ((t + 1) & 1)
                                              * slot);
#pragma unroll
      for (int k = sub; k < CS; k += SUBS)
        store_cluster(map_rank(dst, (unsigned)k), h);
    }
    cluster_arrive();
    if (live && sub == 0) {
      const size_t at = ((size_t)b * S + t) * d + head * du + v;
      put(h_out + at, h);
      if (save) save_step(save, gstride, at, c, n, m, h, zt, it,
                          p[2] + acc[2], ot);
    }
    cluster_wait();        // also keeps every CTA alive past the last store
  }
  if (live && sub == 0) {
    const size_t o = (size_t)b * d + head * du + v;
    c_out[o] = c;
    n_out[o] = n;
    hl_out[o] = h;
    m_out[o] = m;
  }
}

template <typename TR, typename TO>
int launch_cluster(const float* pre, const void* r, void* h_out,
                   float* c_out, float* n_out, float* hl_out, float* m_out,
                   float* save, int B, int S, int H, int du, size_t smem,
                   cudaStream_t stream) {
  auto kernel = slstm_scan_cluster<TR, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int units = du / CS, nb = (B + ROWS - 1) / ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * CS, 1, 1);
  cfg.blockDim = dim3(units * nb * LG, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, pre, static_cast<const TR*>(r),
                         static_cast<TO*>(h_out), c_out, n_out, hl_out,
                         m_out, save, B, S, H, du, units);
  if (e != cudaSuccess) return (int)e;
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward: replaces what the reference differentiates with jax.vjp,
// the lax.scan of slstm_scan (src/repro/models/xlstm.py); the reverse
// chain, from the forward's saved steps.  Per
// unit and row, step t from S - 1 down, with dh_t = h's cotangent plus
// sum_k sum_v R[k, hd, u, v] dg_{t+1}[k, v] (and the final h's cotangent
// at S - 1), and dc, dn, dm carried (seeded by the final state's):
//   d(o c) = dh / max(n, 1e-6): do = d(oc) c, dc += d(oc) o,
//            dn -= d(oc) o c / max(n, 1e-6) (1 above 1e-6, 0.5 at it)
//   dfp = dc c_{t-1} + dn n_{t-1}, dip = dc z + dn, dz = dc ip
//   dm -= dip ip + dfp fp; m = max(a, i), a = log_sigmoid(f) + m_{t-1}:
//   da = dfp fp + dm [a > i] (0.5 at a tie), di = dip ip + dm [i > a]
//   dg = (dz (1 - z^2), di, da sigmoid(-f), do o (1 - o)) -> dpre
//   then dc *= fp, dn *= fp, dm = da for step t - 1.
// The same operations as the forward recompute lf, ip and fp from the
// saved gates and state, so they are the forward's bits.  dR = sum over b
// and t of h_{t-1}^T dg_t is one batched product after the chain, outside
// (kernels/slstm_scan/kernel.py).
//
// What bounds it: the chain again, one dependent step after another, with
// 2 B S 4 H du^2 operations for the R^T dg products (the forward's count)
// and the saved steps' 8 B S d f32 read.

struct StepIn {       // what step t's cell backward reads
  float c, n, m, z, i, f, o, hc;
};

__device__ __forceinline__ StepIn load_step(const float* save, size_t plane,
                                            const float* h_cot, size_t at) {
  StepIn s;
  s.c = __ldg(save + at);
  s.n = __ldg(save + plane + at);
  s.m = __ldg(save + 2 * plane + at);
  s.z = __ldg(save + 4 * plane + at);
  s.i = __ldg(save + 5 * plane + at);
  s.f = __ldg(save + 6 * plane + at);
  s.o = __ldg(save + 7 * plane + at);
  s.hc = __ldg(h_cot + at);
  return s;
}

// the cell backward of one step: updates dc, dn, dm to step t - 1's and
// writes the four gates' dg; (c0, n0, m0) is the state before the step
__device__ __forceinline__ void cell_bwd(const StepIn& s, float c0, float n0,
                                         float m0, float dh, float& dc,
                                         float& dn, float& dm, float* dg) {
  const float lf = log_sigmoid(s.f);
  const float a = lf + m0;
  const float ip = expf(s.i - s.m);
  const float fp = expf(a - s.m);
  const float den = fmaxf(s.n, 1e-6f);
  const float doc = dh / den;
  dc += doc * s.o;
  const float wn = s.n > 1e-6f ? 1.f : (s.n == 1e-6f ? 0.5f : 0.f);
  dn -= doc * (s.o * s.c / den) * wn;
  const float dfp = dc * c0 + dn * n0;
  const float dip = dc * s.z + dn;
  dm -= dip * ip + dfp * fp;
  const float wa = a > s.i ? 1.f : (a == s.i ? 0.5f : 0.f);
  const float da = dfp * fp + dm * wa;
  dg[0] = dc * ip * (1.f - s.z * s.z);
  dg[1] = dip * ip + dm * (1.f - wa);
  dg[2] = da / (1.f + expf(s.f));
  dg[3] = doc * s.c * s.o * (1.f - s.o);
  dc *= fp;
  dn *= fp;
  dm = da;
}

// Route "block": one block per head, 4 du threads.  Each step thread
// (k, u) forms sum_v R[k, hd, u, v] dg_{t+1}[k, b, v] for every row (row
// u of R[k, hd], from L2; dg from shared memory), a barrier, then threads
// (b, u) add the four gates' sums in a fixed order and apply the cell
// backward, keeping dc, dn, dm in shared memory; a second barrier ends the
// step.  Shared memory 11 B du floats: dg [4][B][du], the sums [4][B][du],
// dc, dn, dm [B][du].
template <typename TR>
__global__ void __launch_bounds__(4 * MAX_UNITS) slstm_bwd_block(
    const float* __restrict__ save, const TR* __restrict__ r,
    const float* __restrict__ h_cot, const float* __restrict__ dc_last,
    const float* __restrict__ dn_last, const float* __restrict__ dh_last,
    const float* __restrict__ dm_last, float* __restrict__ dpre, int B,
    int S, int H, int du) {
  extern __shared__ float smem[];
  const int d = H * du, bu = B * du;
  float* dgs = smem;           // [4][B][du]
  float* part = dgs + 4 * bu;  // [4][B][du]
  float* dcs = part + 4 * bu;  // [B][du]
  float* dns = dcs + bu;
  float* dms = dns + bu;
  const int head = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int gate = tid / du, u = tid - gate * du;
  const size_t plane = (size_t)B * S * d;
  for (int i = tid; i < 4 * bu; i += nt) dgs[i] = 0.f;
  for (int i = tid; i < bu; i += nt) {
    const size_t o = (size_t)(i / du) * d + head * du + i % du;
    dcs[i] = dc_last[o];
    dns[i] = dn_last[o];
    dms[i] = dm_last[o];
  }
  __syncthreads();
  const TR* rrow = r + (((size_t)gate * H + head) * du + u) * du;
  for (int t = S - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += BATCH_GROUP) {
      const int nb = min(BATCH_GROUP, B - b0);
      float acc[BATCH_GROUP];
#pragma unroll
      for (int j = 0; j < BATCH_GROUP; ++j) acc[j] = 0.f;
      const float* g = dgs + (gate * B + b0) * du;
#pragma unroll 8
      for (int v = 0; v < du; ++v) {
        const float w = widen(rrow[v]);
#pragma unroll
        for (int j = 0; j < BATCH_GROUP; ++j)
          if (j < nb) acc[j] = fmaf(g[j * du + v], w, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < BATCH_GROUP; ++j)
        if (j < nb) part[(gate * B + b0 + j) * du + u] = acc[j];
    }
    __syncthreads();
    for (int i = tid; i < bu; i += nt) {
      const int b = i / du, uu = i - b * du;
      const size_t at = ((size_t)b * S + t) * d + head * du + uu;
      float dh = part[i] + part[bu + i] + part[2 * bu + i] + part[3 * bu + i];
      const StepIn s = load_step(save, plane, h_cot, at);
      dh += s.hc;
      if (t == S - 1) dh += dh_last[(size_t)b * d + head * du + uu];
      const bool first = t == 0;
      const float c0 = first ? 0.f : __ldg(save + at - d);
      const float n0 = first ? 0.f : __ldg(save + plane + at - d);
      const float m0 = first ? 0.f : __ldg(save + 2 * plane + at - d);
      float dg[4];
      cell_bwd(s, c0, n0, m0, dh, dcs[i], dns[i], dms[i], dg);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dgs[k * bu + i] = dg[k];
        dpre[k * plane + at] = dg[k];
      }
    }
    __syncthreads();
  }
}

// elements of a row u of the backward's R slice: the CTA's U units v of 4
// gates, padded so that consecutive rows lie 4 entries past a multiple of
// 128 bytes (a warp's 32 rows read as 32 consecutive 4-entry groups)
__host__ __device__ __forceinline__ int r_stride_bwd(int units, int el) {
  const int bytes = 4 * units * el;
  return (bytes + (4 * el - bytes % 128 + 128) % 128) / el;
}

// shared memory of the cluster route's backward: the partial sums of dh
// of its own units from every CTA, twice; its own units' dg; the R slice
__host__ __device__ __forceinline__ size_t cluster_bwd_smem(int B, int du,
                                                            int units,
                                                            int el) {
  const int hrow = ROWS * ((B + ROWS - 1) / ROWS);
  return sizeof(float) * ((size_t)2 * CS * units * hrow
                          + (size_t)units * hrow * 4)
         + (size_t)du * r_stride_bwd(units, el) * el;
}

__device__ __forceinline__ void store_cluster4(uint32_t addr, float a,
                                               float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Route "cluster": the forward's layout, the all-gather of dg turned into a
// reduce-scatter of dh.  A cluster of CS CTAs per head; CTA c owns the
// units v in [c U, (c+1) U) and keeps the forward's R slice, R[k, hd, u,
// v] for every u and its own v, as rs[u][v][k] (rows padded by
// r_stride_bwd).  Each step every thread (u, block of RT rows) forms the
// partial sum_{k, v own} R[k, u, v] dg_{t+1}[k, v] of its rows from the
// CTA's own dg (in shared memory, read as broadcasts) and stores it, 16
// bytes a remote store, into slot t % 2 of the CTA that owns u: 1,024
// remote floats a CTA a step at B 4, the forward's count, where storing
// each unit's four dg into all 8 CTAs would be 4,096.  One cluster
// barrier; then the owner's cell threads (unit, row) add the CS partials
// in rank order, apply the cell backward and write dg into their own CTA
// only; a CTA barrier ends the step.  Sums in fixed orders: two calls give
// the same bits.  A step's saved values are loaded two steps ahead.
// With RU = 32 units a CTA (du 256) a thread holds its row of the slice
// in registers and takes all RT = 4 or 8 rows (B up to 8), du threads a
// CTA; else it reads the row from shared memory each step, RT = 4 rows a
// thread.  At xlstm-350m's B 4, S 2048 the chain takes ~2.4 us a step in
// bf16 and f32 on an H100 against ~3.8 us when every CTA gathered every
// unit's dg (bench/scan_bwd.py, PERF.md): the step's latency, its FMAs
// and broadcast reads, one cluster barrier and the cell, sets it.
template <typename TR, int RU, int RT, int MAXT>
__global__ void __launch_bounds__(MAXT, 1) slstm_bwd_cluster(
    const float* __restrict__ save, const TR* __restrict__ r,
    const float* __restrict__ h_cot, const float* __restrict__ dc_last,
    const float* __restrict__ dn_last, const float* __restrict__ dh_last,
    const float* __restrict__ dm_last, float* __restrict__ dpre, int B,
    int S, int H, int du, int units) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = (B + ROWS - 1) / ROWS, hrow = ROWS * nb, d = H * du;
  const int slot = CS * units * hrow;                 // floats of a slot
  float* pbuf = reinterpret_cast<float*>(smem_raw);   // [2][CS][units][hrow]
  float* dgb = pbuf + 2 * slot;                       // [units][hrow][4]
  TR* rs = reinterpret_cast<TR*>(dgb + units * hrow * 4);  // [du][rstride]
  const int rstride = r_stride_bwd(units, (int)sizeof(TR));
  const unsigned rank = cluster_rank();
  const int head = blockIdx.x / CS, tid = threadIdx.x, nt = blockDim.x;
  // as a partial thread: row u of R, rows RT rb.. of the batch
  const int u = tid % du, rb = tid / du;
  // as a cell thread (tid < units hrow): own unit w, row b
  const bool cell = tid < units * hrow;
  const int w = tid / hrow, b = tid % hrow;
  const int v = (int)rank * units + w;            // its unit in the head
  const bool live = cell && b < B;

  for (int i = tid; i < units * hrow * 4; i += nt) dgb[i] = 0.f;
  for (int i = tid; i < 4 * du * units; i += nt) {
    const int ww = i % units, uu = (i / units) % du, k = i / (units * du);
    rs[uu * rstride + ww * 4 + k] =
        r[((size_t)(k * H + head) * du + uu) * du + rank * units + ww];
  }
  cluster_arrive();          // every CTA set up before any remote store
  cluster_wait();

  const size_t plane = (size_t)B * S * d;
  const size_t col = (size_t)(live ? b : 0) * S * d + head * du + v;
  const size_t fin = (size_t)(live ? b : 0) * d + head * du + v;
  float dc = live ? dc_last[fin] : 0.f, dn = live ? dn_last[fin] : 0.f;
  float dm = live ? dm_last[fin] : 0.f;
  const float dh_end = live ? dh_last[fin] : 0.f;
  const TR* rrow = rs + u * rstride;
  // RU > 0 (RU = units): the thread's row of the slice held in registers
  decltype(load4(rrow)) rreg[RU > 0 ? RU : 1];
  if constexpr (RU > 0) {
#pragma unroll
    for (int ww = 0; ww < RU; ++ww) rreg[ww] = load4(rrow + ww * 4);
  }
  const float* grow = dgb + rb * RT * 4;
  // where this thread's partial goes: slot 0, this CTA's rank, unit u % U
  const uint32_t pdst = (uint32_t)__cvta_generic_to_shared(pbuf)
      + (uint32_t)(sizeof(float) * (((int)rank * units + u % units) * hrow
                                    + rb * RT));
  const unsigned owner = (unsigned)(u / units);
  StepIn cur = {}, nxt = {};
  if (live) {
    cur = load_step(save, plane, h_cot, col + (size_t)(S - 1) * d);
    if (S > 1) nxt = load_step(save, plane, h_cot, col + (size_t)(S - 2) * d);
  }
  for (int t = S - 1; t >= 0; --t) {
    StepIn after = {};
    // issued now, used two steps later: the saved steps are off the chain
    if (live && t >= 2)
      after = load_step(save, plane, h_cot, col + (size_t)(t - 2) * d);
    // acc[j]: row RT rb + j, over this CTA's units and the four gates
    float acc[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[j] = 0.f;
    const auto add = [&](int ww, const float (&rk)[4]) {
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float4 g = *reinterpret_cast<const float4*>(
            grow + (ww * hrow + j) * 4);
        acc[j] = fmaf(rk[0], g.x, acc[j]);
        acc[j] = fmaf(rk[1], g.y, acc[j]);
        acc[j] = fmaf(rk[2], g.z, acc[j]);
        acc[j] = fmaf(rk[3], g.w, acc[j]);
      }
    };
    if constexpr (RU > 0) {
#pragma unroll
      for (int ww = 0; ww < RU; ++ww) {
        float rk[4];
        widen4(rreg[ww], rk);
        add(ww, rk);
      }
    } else {
#pragma unroll 4
      for (int ww = 0; ww < units; ++ww) {
        float rk[4];
        widen4(load4(rrow + ww * 4), rk);
        add(ww, rk);
      }
    }
#pragma unroll
    for (int j = 0; j < RT; j += 4)
      store_cluster4(map_rank(pdst + (uint32_t)(sizeof(float) *
                                                ((t & 1) * slot + j)),
                              owner),
                     acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    cluster_arrive();
    cluster_wait();
    if (cell) {
      const float* ps = pbuf + (t & 1) * slot + w * hrow + b;
      float dh = 0.f;
#pragma unroll
      for (int k = 0; k < CS; ++k) dh += ps[k * units * hrow];
      dh += cur.hc;
      if (t == S - 1) dh += dh_end;
      float dg[4];
      cell_bwd(cur, t ? nxt.c : 0.f, t ? nxt.n : 0.f, t ? nxt.m : 0.f, dh,
               dc, dn, dm, dg);
      if (!live) dg[0] = dg[1] = dg[2] = dg[3] = 0.f;
      *reinterpret_cast<float4*>(dgb + (w * hrow + b) * 4) =
          make_float4(dg[0], dg[1], dg[2], dg[3]);
      if (live) {
        const size_t at = col + (size_t)t * d;
#pragma unroll
        for (int k = 0; k < 4; ++k) dpre[k * plane + at] = dg[k];
      }
    }
    cur = nxt;
    nxt = after;
    __syncthreads();       // dg of this step written before the next reads
  }
}

template <typename TR>
int launch_bwd(const float* save, const void* r, const float* h_cot,
               const float* const* dlast, float* dpre, int B, int S, int H,
               int du, bool cluster, cudaStream_t stream) {
  const TR* rr = static_cast<const TR*>(r);
  if (!cluster) {
    const size_t smem = sizeof(float) * 11 * (size_t)B * du;
    auto kernel = slstm_bwd_block<TR>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<H, 4 * du, smem, stream>>>(save, rr, h_cot, dlast[0], dlast[1],
                                        dlast[2], dlast[3], dpre, B, S, H,
                                        du);
    return static_cast<int>(cudaGetLastError());
  }
  const int units = du / CS, nb = (B + ROWS - 1) / ROWS;
  const size_t smem = cluster_bwd_smem(B, du, units, (int)sizeof(TR));
  // R's row in registers where a CTA has 32 units (xlstm-350m's du 256): a
  // thread per u, for all 4 or 8 rows (up to B 8), du threads; else R read
  // from shared memory each step, a thread per (u, 4 rows)
  const bool in_regs = units == REG_UNITS && nb <= 2;
  auto kernel = !in_regs ? slstm_bwd_cluster<TR, 0, ROWS, CLUSTER_THREADS>
                : nb == 1
                    ? slstm_bwd_cluster<TR, REG_UNITS, ROWS, REG_THREADS>
                    : slstm_bwd_cluster<TR, REG_UNITS, 2 * ROWS, REG_THREADS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * CS, 1, 1);
  cfg.blockDim = dim3(in_regs ? du : units * nb * LG, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, save, rr, h_cot, dlast[0], dlast[1],
                         dlast[2], dlast[3], dpre, B, S, H, du, units);
  if (e != cudaSuccess) return (int)e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pre [4, B, S, H du] f32, r [4, H, du, du] (r_bf16: bf16, else f32) ->
// h_out [B, S, H du] (out_bf16: bf16, else f32) and the final c, n, h, m
// [B, H du] f32; unless save is null, also save [8, B, S, H du] f32 (c, n,
// m, h, z, i, f, o each step, for the backward).  1 <= du <= 256, B, S,
// H >= 1, and 32 B du bytes of shared memory at most 232,448.  Returns
// cudaGetLastError() after the launch.
int slstm_scan(const void* pre, const void* r, int r_bf16, void* h_out,
               int out_bf16, void* c_out, void* n_out, void* hl_out,
               void* m_out, void* save, int B, int S, int H, int du,
               void* stream) {
  if (B < 1 || S < 1 || H < 1 || du < 1 || du > MAX_UNITS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 8 * (size_t)B * du;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pre);
  float* c = static_cast<float*>(c_out);
  float* n = static_cast<float*>(n_out);
  float* hl = static_cast<float*>(hl_out);
  float* m = static_cast<float*>(m_out);
  float* sv = static_cast<float*>(save);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                          p, r, h_out, c, n, hl, m, sv, B, S, H, du, smem, s)
                    : launch<__nv_bfloat16, float>(p, r, h_out, c, n, hl, m,
                                                   sv, B, S, H, du, smem, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(p, r, h_out, c, n, hl, m,
                                                 sv, B, S, H, du, smem, s)
                  : launch<float, float>(p, r, h_out, c, n, hl, m, sv, B, S,
                                         H, du, smem, s);
}

// The cluster route: as slstm_scan, in one launch of H clusters of 8 CTAs
// (8 dividing du) of du / 8 * ceil(B / 4) * 8 threads (a multiple of 32 and
// at most 512), each CTA with its R slice, the head's h twice and nothing
// else in shared memory (at most 232,448 bytes).  Returns
// cudaGetLastError() after the launch.
int slstm_scan_cluster(const void* pre, const void* r, int r_bf16,
                       void* h_out, int out_bf16, void* c_out, void* n_out,
                       void* hl_out, void* m_out, void* save, int B, int S,
                       int H, int du, void* stream) {
  if (B < 1 || S < 1 || H < 1 || du < 1 || du % CS)
    return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)(du / CS) * ((B + ROWS - 1) / ROWS) * LG;
  if (threads % 32 || threads > CLUSTER_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(B, du, du / CS, r_bf16 ? 2 : 4);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pre);
  float* c = static_cast<float*>(c_out);
  float* n = static_cast<float*>(n_out);
  float* hl = static_cast<float*>(hl_out);
  float* m = static_cast<float*>(m_out);
  float* sv = static_cast<float*>(save);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_bf16)
    return out_bf16
        ? launch_cluster<__nv_bfloat16, __nv_bfloat16>(
              p, r, h_out, c, n, hl, m, sv, B, S, H, du, smem, s)
        : launch_cluster<__nv_bfloat16, float>(
              p, r, h_out, c, n, hl, m, sv, B, S, H, du, smem, s);
  return out_bf16
      ? launch_cluster<float, __nv_bfloat16>(
            p, r, h_out, c, n, hl, m, sv, B, S, H, du, smem, s)
      : launch_cluster<float, float>(p, r, h_out, c, n, hl, m, sv, B, S,
                                     H, du, smem, s);
}

// The backward of slstm_scan from what it saved: save [8, B, S, H du] and
// r [4, H, du, du] (r_bf16: bf16, else f32), h_cot [B, S, H du] f32 (h's
// cotangent) and dc, dn, dh, dm [B, H du] f32 (the final state's) -> dpre
// [4, B, S, H du] f32.  cluster: the cluster route (the forward cluster
// route's bounds on du and threads, and cluster_bwd_smem bytes at most
// 232,448), else the block route (du <= 256, 44 B du bytes at most
// 232,448).  Returns cudaGetLastError() after the launch.
int slstm_scan_bwd(const void* save, const void* r, int r_bf16,
                   const void* h_cot, const void* dc, const void* dn,
                   const void* dh, const void* dm, void* dpre, int cluster,
                   int B, int S, int H, int du, void* stream) {
  if (B < 1 || S < 1 || H < 1 || du < 1) return (int)cudaErrorInvalidValue;
  if (cluster) {
    const long long threads =
        (long long)(du / CS) * ((B + ROWS - 1) / ROWS) * LG;
    if (du % CS || threads % 32 || threads > CLUSTER_THREADS ||
        cluster_bwd_smem(B, du, du / CS, r_bf16 ? 2 : 4) > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
  } else if (du > MAX_UNITS || sizeof(float) * 11 * (size_t)B * du >
                                   SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const float* dlast[4] = {static_cast<const float*>(dc),
                           static_cast<const float*>(dn),
                           static_cast<const float*>(dh),
                           static_cast<const float*>(dm)};
  const float* sv = static_cast<const float*>(save);
  const float* hc = static_cast<const float*>(h_cot);
  float* out = static_cast<float*>(dpre);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return r_bf16 ? launch_bwd<__nv_bfloat16>(sv, r, hc, dlast, out, B, S, H,
                                            du, cluster, s)
                : launch_bwd<float>(sv, r, hc, dlast, out, B, S, H, du,
                                    cluster, s);
}

}  // extern "C"
