// Placement of one run of single-task arrival batches of the fleet engine:
// per task, the earliest-finish node over the fleet, and the node's
// availability moved to that finish, in arrival order.
//
// Replaces: src/repro/sim/fleet.py, _singleton_scan / _place_singleton_run
// (not a Pallas kernel: a jitted lax.scan that XLA runs on the
// accelerator), which the reference's fleet engine takes for every run of
// at least _SCAN_MIN = 512 consecutive one-task batches.  At 10^5 diurnal
// arrivals nearly every batch holds one task, so this places almost the
// whole run.
//
// The function, step k of n (task k, arriving at ts[k] in tick segment
// segs[k], with fls[k] FLOPs and ibs[k] input bytes):
//   etc[i]  = fls[k] / peak_eff[i] + ibs[k] / bwc_rows[segs[k], i]
//   fin[i]  = max(avail[i], ts[k]) + etc[i]
//   j       = the first index of the least fin
//   start_k = max(avail[j], ts[k]),  finish_k = fin[j],  etc_k = etc[j]
//   avail[j] = fin[j]
// For one task a batch, min-min and HEFT reduce to this same update.  It
// equals the host loop (src/repro/sim/fleet.py:463-476) bit for bit in f64:
// two IEEE divisions, two additions and a max per node, written with the
// round-to-nearest intrinsics so nothing is contracted, and np.argmin's
// first-index rule on ties.  Inputs are finite (no NaN).  Never build with
// --use_fast_math.
//
// What bounds it on the H100: the dependency chain, not bytes or
// operations.  Each step reads the avail that the step before wrote, so
// the n steps run one after another.  At 10^5 tasks over 2,646 bandwidth
// rows × 256 nodes the inputs and outputs are ~11.8 MB, ~3.5 us at
// 3.35 TB/s, and the 6 N f64 operations a step ~4.5 us at 34 TFLOP/s:
// both are orders below the chain.
//
// Only max, add and the argmin depend on the step before; etc does not
// read avail.  So the divisions leave the chain.  One block of 16 warps:
// warp 0 (the consumer) places the steps one after another, and the 12
// warps that do not share its scheduler (warp w issues from scheduler
// w % 4 on the H100) are the producers: they write the etc rows and
// arrival times of the next chunk of `chunk` steps into the other half of
// a shared-memory double buffer, with the same __ddiv_rn / __dadd_rn.
// Warps 4, 8 and 12 only meet the barriers, so no producer takes an issue
// slot from the consumer.  One barrier a chunk swaps the halves.  Per
// step the consumer runs a max and an add per node, then the warp's least
// (fin, index).
//
// The consumer's lane l owns nodes l, l + 32, ...: after the start only
// lane l reads or writes their avail, so a step needs no barrier.  Each
// lane keeps its best (fin, index) over its nodes, replacing it only on a
// strict '<' so its lowest index wins ties.  The warp's least fin is found
// on an order-preserving 64-bit key of it (sign bit flipped for fin >= 0,
// all bits for fin < 0; -0 keyed as +0, so equal doubles give equal keys),
// its high then its low half, and then the least index among the lanes
// that hold it: np.argmin's first index.  The owner lane of the winner
// (j % 32) writes the step's four outputs and its avail.
//
// Two routes, by the number of nodes N (kernels/fleet_scan/kernel.py:
// choose_route):
//  - "registers", N <= 256: lane l keeps the avail of its P = ceil(N/32)
//    nodes in registers (a template on P, so no register array is indexed
//    at run time; the owner updates its slot by an unrolled predicated
//    select), loads the etc values of step s + 1 from the producers' chunk
//    while it reduces step s, and finds its best node by a tree of strict
//    compares (left first: the lowest index on ties).  The warp's argmin
//    is the same three dependent redux.sync minima as "shared": two
//    cheaper ones (the two key minima then a ballot, the index minimum
//    only on a tie across lanes; the high half's minimum and a ballot
//    first) ran within 2% of it at 256 nodes on an H100, their order
//    flipping between runs (PERF.md), since the step is the consumer's
//    stream of instructions, not its reductions.  At 256 nodes the
//    consumer alone sets the step and the producers alone come within
//    ~80% of it (PERF.md), so a faster step needs both to change.
//  - "shared", N > 256 up to MAX_NODES: avail in shared memory, the lane's
//    nodes compared one after another, three dependent redux.sync minima
//    (the first design).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;             // warp 0 consumes
constexpr int PRODUCERS = THREADS / 4 * 3;   // warps w with w % 4 != 0
constexpr int MAX_CHUNK = 64;            // steps a buffer half holds
constexpr size_t SMEM_MAX = 232448;      // dynamic shared memory a block
constexpr int MAX_SLOTS = 8;             // nodes a lane, "registers" route

// etc rows of steps [k0, k0 + cn) into buf [cn, n_nodes] and their
// arrival times into tbuf [cn], by producer t of nt
__device__ __forceinline__ void produce(
    double* __restrict__ buf, double* __restrict__ tbuf,
    const double* __restrict__ peak_eff, const double* __restrict__ bwc_rows,
    const double* __restrict__ ts, const double* __restrict__ fls,
    const double* __restrict__ ibs, const int64_t* __restrict__ segs,
    int n_nodes, long long k0, int cn, int t, int nt) {
  for (int s = t; s < cn; s += nt) tbuf[s] = __ldg(ts + k0 + s);
  const int total = cn * n_nodes;
#pragma unroll 4
  for (int idx = t; idx < total; idx += nt) {
    const int s = idx / n_nodes;
    const int i = idx - s * n_nodes;
    const long long k = k0 + s;
    buf[idx] = __dadd_rn(
        __ddiv_rn(__ldg(fls + k), __ldg(peak_eff + i)),
        __ddiv_rn(__ldg(ibs + k),
                  __ldg(bwc_rows + __ldg(segs + k) * n_nodes + i)));
  }
}

__device__ __forceinline__ unsigned long long order_key(double f) {
  constexpr unsigned long long SIGN = 0x8000000000000000ULL;
  const unsigned long long b = (unsigned long long)__double_as_longlong(f);
  return b == SIGN ? SIGN : (b & SIGN) ? ~b : b | SIGN;   // -0 keyed as +0
}

__global__ void __launch_bounds__(THREADS, 1)
    singleton_scan(double* __restrict__ avail,
                   const double* __restrict__ peak_eff,
                   const double* __restrict__ bwc_rows,
                   const double* __restrict__ ts,
                   const double* __restrict__ fls,
                   const double* __restrict__ ibs,
                   const int64_t* __restrict__ segs, int n_nodes,
                   long long n_steps, int chunk,
                   int64_t* __restrict__ j_out,
                   double* __restrict__ start_out,
                   double* __restrict__ finish_out,
                   double* __restrict__ etc_out) {
  extern __shared__ double smem[];
  double* s_avail = smem;                          // [n_nodes]
  double* s_t = smem + n_nodes;                    // [2, chunk]
  double* ring = s_t + 2 * chunk;                  // [2, chunk, n_nodes]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (n_steps <= 0) return;
  const long long n_chunks = (n_steps + chunk - 1) / chunk;
  for (int i = tid; i < n_nodes; i += THREADS) s_avail[i] = avail[i];
  produce(ring, s_t, peak_eff, bwc_rows, ts, fls, ibs, segs, n_nodes, 0,
          (int)(n_steps < chunk ? n_steps : chunk), tid, THREADS);
  __syncthreads();
  for (long long c = 0; c < n_chunks; ++c) {
    const long long k0 = c * chunk;
    const int cn = (int)(n_steps - k0 < chunk ? n_steps - k0 : chunk);
    const double* cur = ring + (size_t)(c & 1) * chunk * n_nodes;
    const double* cur_t = s_t + (c & 1) * chunk;
    if (warp & 3) {
      const long long k1 = k0 + chunk;
      if (k1 < n_steps)
        produce(ring + (size_t)((c + 1) & 1) * chunk * n_nodes,
                s_t + ((c + 1) & 1) * chunk, peak_eff, bwc_rows, ts, fls,
                ibs, segs, n_nodes, k1,
                (int)(n_steps - k1 < chunk ? n_steps - k1 : chunk),
                (warp - (warp >> 2) - 1) * 32 + lane, PRODUCERS);
    } else if (warp == 0) {
      for (int s = 0; s < cn; ++s) {
        const double* er = cur + (size_t)s * n_nodes;
        const double t = cur_t[s];
        double best_fin = 0.0, best_start = 0.0, best_etc = 0.0;
        int best_j = -1;
#pragma unroll 4
        for (int i = lane; i < n_nodes; i += 32) {
          const double st = fmax(s_avail[i], t), e = er[i];
          const double f = __dadd_rn(st, e);
          if (best_j < 0 || f < best_fin) {
            best_fin = f;
            best_start = st;
            best_etc = e;
            best_j = i;
          }
        }
        const unsigned long long key =
            best_j < 0 ? ~0ULL : order_key(best_fin);
        const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
        const unsigned m_hi = __reduce_min_sync(FULL, hi);
        const unsigned m_lo =
            __reduce_min_sync(FULL, hi == m_hi ? lo : 0xffffffffu);
        const unsigned j = __reduce_min_sync(
            FULL, hi == m_hi && lo == m_lo ? (unsigned)best_j : 0xffffffffu);
        if ((int)(j & 31) == lane) {      // the owner of node j
          const long long k = k0 + s;
          start_out[k] = best_start;
          finish_out[k] = best_fin;
          etc_out[k] = best_etc;
          j_out[k] = j;
          s_avail[j] = best_fin;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n_nodes; i += THREADS) avail[i] = s_avail[i];
}


// The warp's argmin over the lanes' best (key, node), node = lane + 32 slot
// (key ~0 for a lane with no node): true on the lane that holds the step's
// node, the least key's lowest index, by three dependent redux.sync minima
// (key high half, low half, index).
__device__ __forceinline__ bool warp_argmin(unsigned long long key,
                                            unsigned node, int lane) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned m_hi = __reduce_min_sync(FULL, hi);
  const unsigned m_lo = __reduce_min_sync(FULL, hi == m_hi ? lo : 0xffffffffu);
  const unsigned j = __reduce_min_sync(
      FULL, hi == m_hi && lo == m_lo ? node : 0xffffffffu);
  return (int)(j & 31) == lane;
}

// Level W of a tree of strict compares over a lane's P slots, the lower
// slot on the left (so the lowest index wins ties), then the next level:
// slot 0 ends with the least fin, its start, and a one-hot mask of its
// slot.  A template, so every index is known when it compiles; the
// winner is carried as a mask, not an index, so no array is ever indexed
// by a value and nothing goes to local memory.
template <int P, int W>
__device__ __forceinline__ void tree_min(double (&f)[P], double (&st)[P],
                                         unsigned (&mk)[P],
                                         const bool (&has)[P]) {
  if constexpr (W < P) {
#pragma unroll
    for (int i = 0; i + W < P; i += 2 * W)
      if (has[i + W] && f[i + W] < f[i]) {
        f[i] = f[i + W];
        st[i] = st[i + W];
        mk[i] = mk[i + W];
      }
    tree_min<P, 2 * W>(f, st, mk, has);
  }
}

// The "registers" route: N <= 32 P nodes, lane l's avail in av[0..P).
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    singleton_scan_registers(double* __restrict__ avail,
                             const double* __restrict__ peak_eff,
                             const double* __restrict__ bwc_rows,
                             const double* __restrict__ ts,
                             const double* __restrict__ fls,
                             const double* __restrict__ ibs,
                             const int64_t* __restrict__ segs, int n_nodes,
                             long long n_steps, int chunk,
                             int64_t* __restrict__ j_out,
                             double* __restrict__ start_out,
                             double* __restrict__ finish_out,
                             double* __restrict__ etc_out) {
  extern __shared__ double smem[];
  double* s_t = smem;                              // [2, chunk]
  double* ring = s_t + 2 * chunk;                  // [2, chunk, n_nodes]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (n_steps <= 0) return;
  const long long n_chunks = (n_steps + chunk - 1) / chunk;
  double av[P];
  bool has[P];                   // lane + 32 i is a node
#pragma unroll
  for (int i = 0; i < P; ++i) {
    has[i] = lane + 32 * i < n_nodes;
    av[i] = warp == 0 && has[i] ? avail[lane + 32 * i] : 0.0;
  }
  produce(ring, s_t, peak_eff, bwc_rows, ts, fls, ibs, segs, n_nodes, 0,
          (int)(n_steps < chunk ? n_steps : chunk), tid, THREADS);
  __syncthreads();
  for (long long c = 0; c < n_chunks; ++c) {
    const long long k0 = c * chunk;
    const int cn = (int)(n_steps - k0 < chunk ? n_steps - k0 : chunk);
    const double* cur = ring + (size_t)(c & 1) * chunk * n_nodes;
    const double* cur_t = s_t + (c & 1) * chunk;
    if (warp & 3) {
      const long long k1 = k0 + chunk;
      if (k1 < n_steps)
        produce(ring + (size_t)((c + 1) & 1) * chunk * n_nodes,
                s_t + ((c + 1) & 1) * chunk, peak_eff, bwc_rows, ts, fls,
                ibs, segs, n_nodes, k1,
                (int)(n_steps - k1 < chunk ? n_steps - k1 : chunk),
                (warp - (warp >> 2) - 1) * 32 + lane, PRODUCERS);
    } else if (warp == 0) {
      double e[P], t = cur_t[0];
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = has[i] ? cur[lane + 32 * i] : 0.0;
      for (int s = 0; s < cn; ++s) {
        double f[P], st[P];
        unsigned mk[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          st[i] = fmax(av[i], t);
          f[i] = __dadd_rn(st[i], e[i]);
          mk[i] = 1u << i;
        }
        // the next step's etc and arrival: off the chain
        double e_next[P], t_next = t;
        if (s + 1 < cn) {
          const double* er = cur + (size_t)(s + 1) * n_nodes;
          t_next = cur_t[s + 1];
#pragma unroll
          for (int i = 0; i < P; ++i)
            e_next[i] = has[i] ? er[lane + 32 * i] : 0.0;
        }
        tree_min<P, 1>(f, st, mk, has);
        const unsigned node = lane + 32 * (__ffs(mk[0]) - 1);
        const unsigned long long key = has[0] ? order_key(f[0]) : ~0ULL;
        if (warp_argmin(key, node, lane)) {
          const long long kk = k0 + s;
#pragma unroll
          for (int i = 0; i < P; ++i)
            if (mk[0] >> i & 1) av[i] = f[0];
          start_out[kk] = st[0];
          finish_out[kk] = f[0];
          etc_out[kk] = cur[(size_t)s * n_nodes + node];   // e of the slot
          j_out[kk] = node;
        }
        if (s + 1 < cn) {
          t = t_next;
#pragma unroll
          for (int i = 0; i < P; ++i) e[i] = e_next[i];
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (has[i]) avail[lane + 32 * i] = av[i];
  }
}

using ScanKernel = void (*)(double*, const double*, const double*,
                            const double*, const double*, const double*,
                            const int64_t*, int, long long, int, int64_t*,
                            double*, double*, double*);

ScanKernel registers_kernel(int p) {
  switch (p) {
    case 1: return singleton_scan_registers<1>;
    case 2: return singleton_scan_registers<2>;
    case 3: return singleton_scan_registers<3>;
    case 4: return singleton_scan_registers<4>;
    case 5: return singleton_scan_registers<5>;
    case 6: return singleton_scan_registers<6>;
    case 7: return singleton_scan_registers<7>;
    case 8: return singleton_scan_registers<8>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// avail [n_nodes] f64 (updated in place), peak_eff [n_nodes] f64, bwc_rows
// [K, n_nodes] f64, ts, fls, ibs [n_steps] f64, segs [n_steps] int64 (each
// in [0, K)) -> j [n_steps] int64, start, finish, etc [n_steps] f64.
// 1 <= n_nodes, with 8 n_nodes bytes of shared memory for avail and
// 16 (n_nodes + 1) a step of the chunk (up to 64 steps, at least 1), so
// at most 232,448 bytes at a chunk of 1.  Returns cudaGetLastError() after
// the launch.
int fleet_scan(void* avail, const void* peak_eff, const void* bwc_rows,
               const void* ts, const void* fls, const void* ibs,
               const void* segs, int n_nodes, long long n_steps, void* j_out,
               void* start_out, void* finish_out, void* etc_out,
               void* stream) {
  if (n_nodes < 1 || n_steps < 0) return (int)cudaErrorInvalidValue;
  const size_t row = sizeof(double) * (size_t)n_nodes;
  const size_t step = 2 * (row + sizeof(double));  // etc row + t, twice
  if (row + step > SMEM_MAX) return (int)cudaErrorInvalidValue;
  size_t chunk = (SMEM_MAX - row) / step;
  if (chunk > MAX_CHUNK) chunk = MAX_CHUNK;
  const size_t smem = row + chunk * step;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        singleton_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  singleton_scan<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(avail), static_cast<const double*>(peak_eff),
      static_cast<const double*>(bwc_rows), static_cast<const double*>(ts),
      static_cast<const double*>(fls), static_cast<const double*>(ibs),
      static_cast<const int64_t*>(segs), n_nodes, n_steps, (int)chunk,
      static_cast<int64_t*>(j_out), static_cast<double*>(start_out),
      static_cast<double*>(finish_out), static_cast<double*>(etc_out));
  return static_cast<int>(cudaGetLastError());
}

// The "registers" route: as fleet_scan, for 1 <= n_nodes <= 256.  Shared
// memory holds only the chunk: 16 (n_nodes + 1) bytes a step, up to 64 steps.
int fleet_scan_registers(void* avail, const void* peak_eff,
                         const void* bwc_rows, const void* ts,
                         const void* fls, const void* ibs, const void* segs,
                         int n_nodes, long long n_steps, void* j_out,
                         void* start_out, void* finish_out, void* etc_out,
                         void* stream) {
  if (n_nodes < 1 || n_nodes > 32 * MAX_SLOTS || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int p = (n_nodes + 31) / 32;
  const ScanKernel kernel = registers_kernel(p);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t step = 2 * sizeof(double) * ((size_t)n_nodes + 1);
  size_t chunk = SMEM_MAX / step;
  if (chunk > MAX_CHUNK) chunk = MAX_CHUNK;
  const size_t smem = chunk * step;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(avail), static_cast<const double*>(peak_eff),
      static_cast<const double*>(bwc_rows), static_cast<const double*>(ts),
      static_cast<const double*>(fls), static_cast<const double*>(ibs),
      static_cast<const int64_t*>(segs), n_nodes, n_steps, (int)chunk,
      static_cast<int64_t*>(j_out), static_cast<double*>(start_out),
      static_cast<double*>(finish_out), static_cast<double*>(etc_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
