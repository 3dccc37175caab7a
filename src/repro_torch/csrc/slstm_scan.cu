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
// The design is the simple one.  One block per head, 4 du threads: thread
// (k, v) owns gate k of unit v.  Each step it reads column v of R[k, hd]
// (neighbouring threads read neighbouring v: coalesced; the whole R, 2 MB
// in bf16 at xlstm-350m's width, stays in L2 across steps) once for every
// 4 batch rows, and h of those rows from shared memory (one address a warp:
// a broadcast).  A barrier; then threads (b, v) apply the cell to the
// head's B du units, keeping c, n and m in shared memory, and write h to
// shared memory and to the output.  A second barrier ends the step.  So
// every step streams the head's 4 du^2 R entries from L2 into one SM.
// On an H100 at xlstm-350m's shape that takes ~25 us a step in bf16 and in
// f32 alike (chip_smoke.py), and variants that read h as 16-byte loads,
// keep 16 R loads in flight a thread, or give each thread four columns
// with one 8- or 16-byte R load a row ran no faster: the step waits on
// its R reads from L2, not on their bytes or on the instructions around
// them.  The faster design (ROADMAP.md) splits a head over a thread-block
// cluster whose CTAs keep their slices of R in shared memory and pass h
// through distributed shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_UNITS = 256;        // 4 du threads a block, at most 1024
constexpr int BATCH_GROUP = 4;        // batch rows a gate thread sums at once
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block

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

// pre [4, B, S, d] f32; r [4, H, du, du]; h_out [B, S, d]; the final
// c, n, h, m [B, d] f32.  Grid H blocks of 4 du threads; shared memory
// 8 B du floats: h [B][du], the gates [4][B][du], c, n, m [B][du].
template <typename TR, typename TO>
__global__ void __launch_bounds__(4 * MAX_UNITS) slstm_scan_kernel(
    const float* __restrict__ pre, const TR* __restrict__ r,
    TO* __restrict__ h_out, float* __restrict__ c_out,
    float* __restrict__ n_out, float* __restrict__ hl_out,
    float* __restrict__ m_out, int B, int S, int H, int du) {
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
      put(h_out + ((size_t)b * S + t) * d + head * du + u, h);
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
           float* n_out, float* hl_out, float* m_out, int B, int S, int H,
           int du, size_t smem, cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<TR, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<H, 4 * du, smem, stream>>>(
      pre, static_cast<const TR*>(r), static_cast<TO*>(h_out), c_out, n_out,
      hl_out, m_out, B, S, H, du);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pre [4, B, S, H du] f32, r [4, H, du, du] (r_bf16: bf16, else f32) ->
// h_out [B, S, H du] (out_bf16: bf16, else f32) and the final c, n, h, m
// [B, H du] f32.  1 <= du <= 256, B, S, H >= 1, and 32 B du bytes of
// shared memory at most 232,448.  Returns cudaGetLastError() after the
// launch.
int slstm_scan(const void* pre, const void* r, int r_bf16, void* h_out,
               int out_bf16, void* c_out, void* n_out, void* hl_out,
               void* m_out, int B, int S, int H, int du, void* stream) {
  if (B < 1 || S < 1 || H < 1 || du < 1 || du > MAX_UNITS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 8 * (size_t)B * du;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pre);
  float* c = static_cast<float*>(c_out);
  float* n = static_cast<float*>(n_out);
  float* hl = static_cast<float*>(hl_out);
  float* m = static_cast<float*>(m_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_bf16)
    return out_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(p, r, h_out, c, n, hl, m, B,
                                               S, H, du, smem, s)
        : launch<__nv_bfloat16, float>(p, r, h_out, c, n, hl, m, B, S, H,
                                       du, smem, s);
  return out_bf16
      ? launch<float, __nv_bfloat16>(p, r, h_out, c, n, hl, m, B, S, H, du,
                                     smem, s)
      : launch<float, float>(p, r, h_out, c, n, hl, m, B, S, H, du, smem, s);
}

}  // extern "C"
