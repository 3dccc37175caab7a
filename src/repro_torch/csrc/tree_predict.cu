// Batched GBT inference over flattened node arrays.
//
// Replaces: src/repro/kernels/tree_predict/kernel.py, tree_predict_kernel
// (the Pallas TPU kernel, body _kernel), which turns every node lookup into
// a one-hot reduction over all max_nodes slots because the TPU's vector
// unit cannot gather per lane.
//
// What bounds it on the H100: at the decision path's shapes (N = 2L = 56
// feature rows, 200 trees of depth <= 12) it is bound by its launch and by
// the latency of the dependent loads of each descent; the bytes (the node
// arrays, a few hundred KB, read once) would take well under a microsecond
// at 3.35 TB/s, and the work is one compare per level and one add per tree.
//
// Design: one thread per row.  Each thread walks the trees in training
// order, descends until it reaches a leaf (at most max_depth levels: a
// split node goes left when code[feature] <= threshold_bin), and adds that
// leaf's value, already scaled by the learning rate, to a register that
// starts at the ensemble's base.  The leaf values and the sum are f64, not
// the TPU kernel's f32: the ensemble's early trees carry leaf values of the
// size of the targets, which cancel against the base down to per-layer
// times orders of magnitude smaller, and in f32 that cancellation cost
// ~1e-2 relative error in predicted times and visibly worse split choices.
// In f64 the additions are the plain version's, in its order, with no
// multiply to contract, so the kernel's result equals it exactly.  Node
// arrays are read through the read-only cache (__ldg), where rows
// descending the same tree share lines.  Staging trees in shared memory is
// left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tree_predict_kernel(const int32_t* __restrict__ codes,
                                    const int32_t* __restrict__ feature,
                                    const int32_t* __restrict__ threshold,
                                    const int32_t* __restrict__ left,
                                    const int32_t* __restrict__ right,
                                    const double* __restrict__ value,
                                    double base, int n_rows, int n_feat,
                                    int n_trees, int max_nodes,
                                    int max_depth,
                                    double* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int32_t* row = codes + (size_t)r * n_feat;
  double acc = base;
  for (int t = 0; t < n_trees; ++t) {
    const size_t first = (size_t)t * max_nodes;
    int node = 0;
    for (int d = 0; d < max_depth; ++d) {
      const int f = __ldg(feature + first + node);
      if (f < 0) break;                       // reached a leaf
      node = row[f] <= __ldg(threshold + first + node)
                 ? __ldg(left + first + node)
                 : __ldg(right + first + node);
    }
    acc = __dadd_rn(acc, __ldg(value + first + node));
  }
  out[r] = acc;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// codes [n_rows, n_feat] int32; feature/threshold/left/right [n_trees,
// max_nodes] int32; value [n_trees, max_nodes] f64 (pre-scaled leaf
// values) -> out [n_rows] f64 = base + the leaf values in tree order.
// Returns cudaGetLastError() after the launch.
int tree_predict(const void* codes, const void* feature,
                 const void* threshold, const void* left, const void* right,
                 const void* value, double base, int n_rows, int n_feat,
                 int n_trees, int max_nodes, int max_depth, void* out,
                 void* stream) {
  const int threads = 128;
  const int blocks = (n_rows + threads - 1) / threads;
  tree_predict_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes),
      static_cast<const int32_t*>(feature),
      static_cast<const int32_t*>(threshold),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(right),
      static_cast<const double*>(value), base, n_rows, n_feat, n_trees,
      max_nodes, max_depth, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
