// Batched GBT inference over flattened node arrays, in two launches.
//
// Replaces: src/repro/kernels/tree_predict/kernel.py, tree_predict_kernel
// (the Pallas TPU kernel, body _kernel), which turns every node lookup into
// a one-hot reduction over all max_nodes slots because the TPU's vector
// unit cannot gather per lane.
//
// What bounds it on the H100: at the decision path's shapes (N = 2L = 56
// feature rows, 200 trees of up to 643 nodes, depth 12) latency: the chain
// of dependent loads of one descent (at most max_depth levels), the chain
// of T f64 additions of one row, and the two launches.  The bytes (the node
// arrays, 3.1 MB, read once) take under a microsecond at 3.35 TB/s, and the
// work is one compare per level and one add per (row, tree).
//
// Design.  tree_descend: every (row, tree) pair descends on a thread of its
// own.  The grid runs over groups of G trees x tiles of R rows (G and R from
// kernel.choose_route, G from max_nodes and the 227 KB of shared memory a
// block can have).  A block stages its G trees in shared memory with
// 16-byte loads, a node as an int4 {feature, threshold, left, right} beside
// its f64 leaf value (24 bytes), and its R rows' codes; then each thread
// walks at most max_depth levels in shared memory (a split node goes left
// when code[feature] <= threshold_bin) and writes the leaf's value, already
// scaled by the learning rate, to leaf[row, tree], an [N, T] f64 scratch.
// A tree too large for shared memory takes the same kernel with its nodes
// read from global memory through __ldg (the "global" route).
//
// tree_fold: a warp for each row copies the row's T leaf values to shared
// memory (all its loads in flight at once), and one lane adds them in tree
// order onto base with __dadd_rn.  Those are the plain version's additions
// in its order (ref.tree_predict_ref: base, then each tree's leaf value),
// so the result equals it bit for bit.  f64 addition is not associative:
// partial sums per block of trees, added up afterwards, would give other
// bits, so the fold stays one chain of T dependent adds per row.
//
// Leaf values and the sum are f64, not the TPU kernel's f32: the
// ensemble's early trees carry leaf values of the size of the targets,
// which cancel against the base down to per-layer times orders of
// magnitude smaller, and in f32 that cancellation cost ~1e-2 relative error
// in predicted times and visibly worse split choices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DESCEND_THREADS = 128;
constexpr int FOLD_WARPS = 4;
constexpr int FOLD_CHUNK = 256;   // leaf values a warp stages per pass

// Copy n int32 from src (4-byte aligned) to dst[STRIDE * i], with 16-byte
// loads from the first 16-byte boundary of src on.
template <int STRIDE>
__device__ __forceinline__ void stage_ints(const int32_t* __restrict__ src,
                                           int n, int* dst) {
  const int head =
      min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15))
                              & 15) / 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[STRIDE * i] = __ldg(src + i);
  const int nv = (n - head) / 4;
  const int4* v = reinterpret_cast<const int4*>(src + head);
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    const int4 x = __ldg(v + j);
    int* d = dst + STRIDE * (head + 4 * j);
    d[0] = x.x;
    d[STRIDE] = x.y;
    d[2 * STRIDE] = x.z;
    d[3 * STRIDE] = x.w;
  }
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[STRIDE * i] = __ldg(src + i);
}

// Copy n f64 from src (8-byte aligned) to dst, with 16-byte loads.
__device__ __forceinline__ void stage_doubles(const double* __restrict__ src,
                                              int n, double* dst) {
  const int head = min(n, (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0);
  if (threadIdx.x < head) dst[0] = __ldg(src);
  const int nv = (n - head) / 2;
  const double2* v = reinterpret_cast<const double2*>(src + head);
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    const double2 x = __ldg(v + j);
    dst[head + 2 * j] = x.x;
    dst[head + 2 * j + 1] = x.y;
  }
  for (int i = head + 2 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

template <bool STAGED>
__global__ void __launch_bounds__(DESCEND_THREADS)
tree_descend_kernel(const int32_t* __restrict__ codes,
                    const int32_t* __restrict__ feature,
                    const int32_t* __restrict__ threshold,
                    const int32_t* __restrict__ left,
                    const int32_t* __restrict__ right,
                    const double* __restrict__ value, int n_rows,
                    int n_feat, int n_trees, int max_nodes, int max_depth,
                    int trees_per_block, int rows_per_block,
                    double* __restrict__ leaf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * trees_per_block;
  const int r0 = blockIdx.y * rows_per_block;
  const int g = min(trees_per_block, n_trees - t0);
  const int rows = min(rows_per_block, n_rows - r0);
  const size_t first = static_cast<size_t>(t0) * max_nodes;
  const int staged = STAGED ? g * max_nodes : 0;
  int4* s_node = reinterpret_cast<int4*>(smem);
  double* s_val = reinterpret_cast<double*>(s_node + staged);
  int* s_codes = reinterpret_cast<int*>(s_val + staged);
  if (STAGED) {
    int* fields = reinterpret_cast<int*>(s_node);
    stage_ints<4>(feature + first, staged, fields);
    stage_ints<4>(threshold + first, staged, fields + 1);
    stage_ints<4>(left + first, staged, fields + 2);
    stage_ints<4>(right + first, staged, fields + 3);
    stage_doubles(value + first, staged, s_val);
  }
  stage_ints<1>(codes + static_cast<size_t>(r0) * n_feat, rows * n_feat,
                s_codes);
  __syncthreads();
  // neighbouring threads take neighbouring trees of one row: the row's
  // codes are a broadcast, and the leaf values land side by side
  for (int p = threadIdx.x; p < g * rows; p += blockDim.x) {
    const int r = p / g, tl = p - r * g;
    const int* row = s_codes + r * n_feat;
    int node = 0;
    double v;
    if (STAGED) {
      const int4* tree = s_node + tl * max_nodes;
      for (int d = 0; d < max_depth; ++d) {
        const int4 nd = tree[node];
        if (nd.x < 0) break;                  // reached a leaf
        node = row[nd.x] <= nd.y ? nd.z : nd.w;
      }
      v = s_val[tl * max_nodes + node];
    } else {
      const size_t at = first + static_cast<size_t>(tl) * max_nodes;
      for (int d = 0; d < max_depth; ++d) {
        const int f = __ldg(feature + at + node);
        if (f < 0) break;
        node = row[f] <= __ldg(threshold + at + node)
                   ? __ldg(left + at + node)
                   : __ldg(right + at + node);
      }
      v = __ldg(value + at + node);
    }
    leaf[static_cast<size_t>(r0 + r) * n_trees + t0 + tl] = v;
  }
}

__global__ void __launch_bounds__(FOLD_WARPS * 32)
tree_fold_kernel(const double* __restrict__ leaf, double base, int n_rows,
                 int n_trees, double* __restrict__ out) {
  __shared__ double s_leaf[FOLD_WARPS][FOLD_CHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * FOLD_WARPS + warp;
  if (r >= n_rows) return;                    // the whole warp: no block sync
  const double* row = leaf + static_cast<size_t>(r) * n_trees;
  double* s = s_leaf[warp];
  double acc = base;
  for (int t0 = 0; t0 < n_trees; t0 += FOLD_CHUNK) {
    const int len = min(FOLD_CHUNK, n_trees - t0);
    __syncwarp();                             // lane 0 has read the last pass
#pragma unroll
    for (int k = 0; k < FOLD_CHUNK / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < len) s[i] = row[t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int i = 0; i < len; ++i) acc = __dadd_rn(acc, s[i]);
    }
  }
  if (lane == 0) out[r] = acc;
}

// The dynamic shared memory each instance has been allowed so far.
int allowed_smem[2] = {48 * 1024, 48 * 1024};

template <bool STAGED>
int launch_descend(const void* codes, const void* feature,
                   const void* threshold, const void* left,
                   const void* right, const void* value, int n_rows,
                   int n_feat, int n_trees, int max_nodes, int max_depth,
                   int trees_per_block, int rows_per_block, void* leaf,
                   cudaStream_t stream) {
  const size_t smem =
      (STAGED ? static_cast<size_t>(trees_per_block) * max_nodes
                    * (sizeof(int4) + sizeof(double))
              : 0)
      + static_cast<size_t>(rows_per_block) * n_feat * sizeof(int);
  if (smem > static_cast<size_t>(allowed_smem[STAGED])) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_descend_kernel<STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem[STAGED] = static_cast<int>(smem);
  }
  const dim3 grid((n_trees + trees_per_block - 1) / trees_per_block,
                  (n_rows + rows_per_block - 1) / rows_per_block);
  tree_descend_kernel<STAGED><<<grid, DESCEND_THREADS, smem, stream>>>(
      static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(feature),
      static_cast<const int32_t*>(threshold),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const double*>(value), n_rows, n_feat, n_trees, max_nodes,
      max_depth, trees_per_block, rows_per_block,
      static_cast<double*>(leaf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// codes [n_rows, n_feat] int32; feature/threshold/left/right [n_trees,
// max_nodes] int32; value [n_trees, max_nodes] f64 (pre-scaled leaf
// values) -> leaf [n_rows, n_trees] f64: each (row, tree)'s leaf value.
// staged != 0 stages trees_per_block trees in shared memory (the caller
// checked that they fit); 0 reads the nodes from global memory.  n_rows and
// n_trees must be > 0.  Returns cudaGetLastError() after the launch.
int tree_descend(const void* codes, const void* feature,
                 const void* threshold, const void* left, const void* right,
                 const void* value, int n_rows, int n_feat, int n_trees,
                 int max_nodes, int max_depth, int trees_per_block,
                 int rows_per_block, int staged, void* leaf, void* stream) {
  auto* launch = staged ? &launch_descend<true> : &launch_descend<false>;
  return launch(codes, feature, threshold, left, right, value, n_rows,
                n_feat, n_trees, max_nodes, max_depth, trees_per_block,
                rows_per_block, leaf, static_cast<cudaStream_t>(stream));
}

// leaf [n_rows, n_trees] f64 -> out [n_rows] f64 = base + each row's leaf
// values, added one at a time in tree order.  n_rows must be > 0.
// Returns cudaGetLastError() after the launch.
int tree_fold(const void* leaf, double base, int n_rows, int n_trees,
              void* out, void* stream) {
  const int blocks = (n_rows + FOLD_WARPS - 1) / FOLD_WARPS;
  tree_fold_kernel<<<blocks, FOLD_WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(leaf), base, n_rows, n_trees,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
