// Per-tree forest margin kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel _tree_step_kernel
// (variantcalling_tpu/models/forest_pallas.py:51), launched by _margin_pallas
// and driven by make_gemm_pallas_predictor. Per 512-row tile and one tree,
// trees innermost, that kernel computes the path-matrix chain of the `gemm`
// strategy: the one-hot feature pick x @ a, the decision <= thr, the routing
// d @ m2 + c, the leaf match == plen, and out += hit @ value, accumulating
// the margin over the trees in order.
//
// This kernel keeps that formulation, with bits in place of the products.
// The routing test d @ m2 + c == plen holds exactly when every node on the
// leaf's left path decided true and every node on its right path decided
// false. So per (row, tree) the kernel first decides every internal node
// into a bitmask d (bit k = node k goes left), then tests every leaf with
// two masks built by the wrapper (models/forest_cuda.py) from m2:
//
//     hit = (d & lmask) == lmask  &&  (d & rmask) == 0
//
// Padded leaves (plen = -1) carry lmask = rmask = bit 0, which never
// matches. The feature pick is an exact read of x[row, feat[k]] (no
// product). With a default-left table the decision is
// isnan(v) ? dleft[k] : v <= thr[k] — the reference's NaN-mask branch
// (models/forest.py predict_margin_gemm); without one it is v <= thr[k].
// Each tree's matching leaf value is added to one float32 accumulator per
// row with __fadd_rn in ascending tree order: the same sum as the TPU
// kernel's out += s and sequential_tree_sum. Output: (N,) float32 margins.
//
// Layout: one thread per variant row, `rows` rows per block (128, fewer
// only when a huge tree's tables need the room). The block stages its
// feature tile in shared memory once (row stride padded to an odd word
// count, so threads reading one feature hit distinct banks), then walks
// the trees in order: stage the tree's node table (feature, threshold
// bits) and default-left bits, decide the nodes into d (kept in shared
// memory, word-major so a warp's words sit in distinct banks), then stage
// the leaf masks and values a tile of `lt` leaves at a time and test
// them. A 64-leaf tree's masks are 1 KB and stage in one tile; a tree of
// 1,024 leaves needs about 260 KB and streams through in tiles.
//
// Bound on this card: bytes, as for the wide kernel (the same function):
// per 262,144-row chunk at F = 19, 19.9 MB of features in and 1 MB of
// margins out; the tables stay in L2. The work is I compares plus
// L * 2 * ceil(I / 32) mask operations per (row, tree), all on shared
// memory — about 320 integer operations for a 64-leaf tree — so this first
// version is limited by shared-memory traffic, far from the bytes bound.
// The contraction form is the one a later version can move onto tensor
// cores ({0,1} x {-1,0,1} products are exact in int8 with int32 sums).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 128;
constexpr int kMinRows = 32;
// leaf tiles are sized to keep a block's shared memory near this, so that
// several blocks share an SM
constexpr long long kTargetSmem = 64 * 1024;

__host__ __device__ inline int x_stride(int f) { return f | 1; }

struct Plan {
  int rows;        // threads (rows) per block; 0 = the tables do not fit
  int lt;          // leaves staged per tile
  long long smem;  // dynamic shared memory bytes
};

__host__ Plan plan(int f, int n_int, int n_leaf, int w, bool has_dleft, int max_optin) {
  const long long per_leaf = (2LL * w + 1) * 4;
  for (int rows = kMaxRows; rows >= kMinRows; rows /= 2) {
    const long long fixed = (long long)n_int * 8 + (long long)rows * w * 4 +
                            (has_dleft ? (long long)w * 4 : 0) + (long long)rows * x_stride(f) * 4;
    long long lt = (kTargetSmem - fixed) / per_leaf;
    if (lt < 32) lt = 32;
    if (lt > n_leaf) lt = n_leaf;
    const long long smem = fixed + lt * per_leaf;
    if (smem <= max_optin) return Plan{rows, (int)lt, smem};
  }
  return Plan{0, 0, 0};
}

__global__ void __launch_bounds__(kMaxRows)
forest_tree_step_kernel(const float* __restrict__ x, long long n, int f,
                        const int2* __restrict__ nodes,         // (T, I): feature, threshold bits
                        const unsigned* __restrict__ dleft,     // (T, W) or null
                        const unsigned* __restrict__ masks,     // (T, L, 2, W): lmask, rmask
                        const float* __restrict__ values,       // (T, L)
                        int n_trees, int n_int, int n_leaf, int w, int lt,
                        float* __restrict__ out) {
  extern __shared__ int2 smem[];
  const int rows_per_block = blockDim.x;
  int2* s_nodes = smem;                                                      // I
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_nodes + n_int);          // lt * 2W
  float* s_val = reinterpret_cast<float*>(s_mask + (long long)lt * 2 * w);  // lt
  unsigned* s_d = reinterpret_cast<unsigned*>(s_val + lt);                  // W * rows
  unsigned* s_dl = s_d + (long long)w * rows_per_block;                     // W, with dleft
  float* s_x = reinterpret_cast<float*>(s_dl + (dleft ? w : 0));            // rows * stride
  const int stride = x_stride(f);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, n - row0);
  const float* xt = x + row0 * f;
  for (int k = threadIdx.x; k < rows * f; k += rows_per_block) {
    const int r = k / f;
    s_x[r * stride + (k - r * f)] = xt[k];
  }
  const int r = threadIdx.x;
  const bool active = r < rows;
  const float* xr = s_x + r * stride;
  unsigned* dr = s_d + r;  // word j of this row's d at dr[j * rows_per_block]
  float acc = 0.0f;

  for (int t = 0; t < n_trees; ++t) {
    const unsigned* tm = masks + (long long)t * n_leaf * 2 * w;
    const float* tv = values + (long long)t * n_leaf;
    float leaf = 0.0f;
    for (int lo = 0; lo < n_leaf; lo += lt) {
      const int cnt = min(lt, n_leaf - lo);
      __syncthreads();  // the previous tile's (and tree's) tables are no longer read
      if (lo == 0) {
        const int2* tn = nodes + (long long)t * n_int;
        for (int k = threadIdx.x; k < n_int; k += rows_per_block) s_nodes[k] = tn[k];
        if (dleft)
          for (int k = threadIdx.x; k < w; k += rows_per_block) s_dl[k] = dleft[(long long)t * w + k];
      }
      const unsigned* tile = tm + (long long)lo * 2 * w;
      for (int k = threadIdx.x; k < cnt * 2 * w; k += rows_per_block) s_mask[k] = tile[k];
      for (int k = threadIdx.x; k < cnt; k += rows_per_block) s_val[k] = tv[lo + k];
      __syncthreads();
      if (!active) continue;
      if (lo == 0) {  // decide every internal node of the tree: d, bit by bit
        for (int j = 0; j < w; ++j) {
          unsigned bits = 0u;
          const int nb = min(32, n_int - 32 * j);
          for (int b = 0; b < nb; ++b) {
            const int2 nd = s_nodes[32 * j + b];
            const float v = xr[nd.x];
            unsigned go_left = v <= __int_as_float(nd.y) ? 1u : 0u;
            if (dleft && isnan(v)) go_left = (s_dl[j] >> b) & 1u;
            bits |= go_left << b;
          }
          dr[j * rows_per_block] = bits;
        }
      }
      for (int l = 0; l < cnt; ++l) {  // test every leaf of the tile
        const unsigned* lm = s_mask + (long long)l * 2 * w;
        bool hit = true;
        for (int j = 0; j < w; ++j) {
          const unsigned dw = dr[j * rows_per_block];
          hit = hit && ((dw & lm[j]) == lm[j]) && ((dw & lm[w + j]) == 0u);
        }
        if (hit) leaf = s_val[l];
      }
    }
    acc = __fadd_rn(acc, leaf);
  }
  if (active) out[row0 + r] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `dleft` may be null (no missing-value routing).
int forest_tree_step_margin(const float* x, long long n, int f, const void* nodes,
                            const unsigned* dleft, const unsigned* masks, const float* values,
                            int n_trees, int n_int, int n_leaf, int w, float* out, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(f, n_int, n_leaf, w, dleft != nullptr, max_optin);
  if (p.rows == 0) return (int)cudaErrorInvalidConfiguration;
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(forest_tree_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (n + p.rows - 1) / p.rows;
  forest_tree_step_kernel<<<(unsigned)grid, p.rows, (size_t)p.smem, (cudaStream_t)stream>>>(
      x, n, f, reinterpret_cast<const int2*>(nodes), dleft, masks, values, n_trees, n_int,
      n_leaf, w, p.lt, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
