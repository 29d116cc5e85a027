// Wide-block forest margin kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel _wide_block_kernel
// (variantcalling_tpu/models/forest_pallas.py:105). Per 512-row tile and
// block of G trees that kernel computes the one-hot feature pick x @ a,
// the compare with thr, the block-diagonal routing d @ m2 + c, the leaf
// match == plen and each tree's leaf value, as MXU contractions; the
// ascending tree sum runs outside it.
//
// This kernel computes the same margins from compact tables that the
// Python wrapper (models/forest_cuda.py) builds once from the forest's
// node arrays, G trees to a block as the wide encoding packs them: per
// internal node its feature index, its threshold, and its two children
// (>= 0 an internal node, < 0 the leaf ~child). Walking them from the
// root reaches exactly the one leaf whose match == plen. The feature pick
// is an exact read of x[row, feat]; there is no product at all.
//
// Layout: one thread per variant row, 256 rows per block. The block first
// stages its (256, F) feature tile in shared memory with coalesced reads
// (row stride padded to an odd word count, so threads reading one feature
// hit distinct banks). It then walks the tree blocks in order: stage one
// block's tables in shared memory, sync, walk its G trees, and add each
// tree's leaf value to the row's float32 accumulator with __fadd_rn in
// ascending tree order (the same sum as sequential_tree_sum). Trees past
// T (padding) and rows past N are skipped. Output: (N,) float32 margins.
//
// Bound on this card: bytes. Per 262,144-row chunk at F = 19 the kernel
// must read 19.9 MB of features and write 1 MB of margins; the tables are
// ~0.1 MB and stay in L2. The design reads each feature byte from device
// memory once (the shared-memory tile) and writes only the summed margin,
// never the (N, T) per-tree margins (105 MB at T = 100). The walk itself
// is ~depth dependent shared-memory loads per (row, tree); making that
// side fast (wgmma/TMA or a register-resident tree layout) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int x_stride(int f) { return f | 1; }

__host__ inline long long smem_bytes(int f, int g, int n_int, int n_leaf) {
  return (long long)g * n_int * 16 + (long long)g * n_leaf * 4 + (long long)g * 4 +
         (long long)kThreads * x_stride(f) * 4;
}

__global__ void __launch_bounds__(kThreads)
forest_wide_margin_kernel(const float* __restrict__ x, long long n, int f,
                          const int4* __restrict__ nodes,      // (B, G*I)
                          const float* __restrict__ leaf_val,  // (B, G*L)
                          const int* __restrict__ roots,       // (B*G)
                          int n_blocks, int g, int n_int, int n_leaf, int n_trees,
                          float* __restrict__ out) {
  extern __shared__ int4 smem[];
  int4* s_nodes = smem;                                          // G*I
  float* s_val = reinterpret_cast<float*>(s_nodes + g * n_int);  // G*L
  int* s_root = reinterpret_cast<int*>(s_val + g * n_leaf);      // G
  float* s_x = reinterpret_cast<float*>(s_root + g);             // kThreads * stride
  const int stride = x_stride(f);

  const long long row0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, n - row0);
  const float* xt = x + row0 * f;
  for (int k = threadIdx.x; k < rows * f; k += kThreads) {
    const int r = k / f;
    s_x[r * stride + (k - r * f)] = xt[k];
  }
  const int r = threadIdx.x;
  const bool active = r < rows;
  const float* xr = s_x + r * stride;
  float acc = 0.0f;

  for (int b = 0; b < n_blocks; ++b) {
    __syncthreads();  // the previous block's tables are no longer read
    const int4* gn = nodes + (long long)b * g * n_int;
    for (int k = threadIdx.x; k < g * n_int; k += kThreads) s_nodes[k] = gn[k];
    const float* gv = leaf_val + (long long)b * g * n_leaf;
    for (int k = threadIdx.x; k < g * n_leaf; k += kThreads) s_val[k] = gv[k];
    for (int k = threadIdx.x; k < g; k += kThreads) s_root[k] = roots[b * g + k];
    __syncthreads();
    if (active) {
      for (int j = 0; j < g && b * g + j < n_trees; ++j) {
        const int4* tn = s_nodes + j * n_int;
        int node = s_root[j];
        while (node >= 0) {
          const int4 nd = tn[node];
          node = (xr[nd.x] <= __int_as_float(nd.y)) ? nd.z : nd.w;
        }
        acc = __fadd_rn(acc, s_val[j * n_leaf + ~node]);
      }
    }
  }
  if (active) out[row0 + r] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int forest_wide_margin(const float* x, long long n, int f, const void* nodes,
                       const float* leaf_val, const int* roots, int n_blocks, int g,
                       int n_int, int n_leaf, int n_trees, float* out, void* stream) {
  if (n <= 0) return 0;
  const long long smem = smem_bytes(f, g, n_int, n_leaf);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > max_optin) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(forest_wide_margin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (n + kThreads - 1) / kThreads;
  forest_wide_margin_kernel<<<(unsigned)grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      x, n, f, reinterpret_cast<const int4*>(nodes), leaf_val, roots, n_blocks, g, n_int,
      n_leaf, n_trees, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
