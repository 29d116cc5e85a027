// Wide-block forest margin kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel _wide_block_kernel
// (variantcalling_tpu/models/forest_pallas.py:105), launched by
// make_wide_pallas_margin_predictor. Per 512-row tile and block of G trees
// that kernel computes the one-hot feature pick x @ a, the compare with thr,
// the block-diagonal routing d @ m2 + c, the leaf match == plen and each
// tree's leaf value, as MXU contractions; the ascending tree sum runs
// outside it. This kernel computes the same (N,) float32 margins by walking
// each tree from its root to the one leaf that the routing selects.
//
// Tables (built once by the wrapper, models/forest_cuda.py compact_tables):
// one 8-byte record per tree node, breadth first from the root, so that an
// internal node's two children sit in adjacent slots:
//   internal: .x = threshold bits, .y = first << 16 | default_left << 15 | feature
//   leaf:     .x = value bits,     .y = slot << 16 | 1 << 15 | F (its own slot)
// A step is next = first + go_right, with go_right = default_left ? v > thr
// : !(v <= thr) — the reference's isnan(v) ? dleft : v <= thr, and NaN to the
// right where the forest has no default_left; a leaf, reading the feature
// tile's extra row F of -inf with its default bit set, steps onto itself, so
// a walk takes its tree's depth in steps whatever leaf it reaches. The
// feature pick is an exact read of x[row, feature]; there is no product. The
// trees are cut into chunks of whole trees, between groups of four where a
// group fits a chunk; one chunk when the forest fits beside the feature tiles
// (100 trees of 64 leaves: 12,700 records, 99 KB; 100 of 256 leaves take 7
// chunks of at most 64 KB). A tree too large for a chunk buffer (more than a
// quarter of the shared memory, 7,264 nodes at least) goes, with the large
// trees next to it, into a global chunk: no copy into shared memory; the walk
// reads its 16-byte records from device memory with __ldg (the L2 cache, 50
// MB, holds them), each with a 32-bit child slot,
//   .x = threshold or value bits, .y = default_left << 15 | feature,
//   .z = first child (a leaf: its own slot), .w = 0,
// so explicit `wide` serves trees of any size. Chunks in shared memory take
// the same path as before, with no extra branch per step.
//
// Layout: a persistent grid of one block per SM (the forest takes most of
// the SM's shared memory), each block walking row tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; one thread per row, `rows` = blockDim.x rows
// a tile (a multiple of 32, at most 512). A block's work is the sequence of
// (tile, chunk) pairs. While it walks one pair, cp.async copies the next
// pair's chunk (when there are several) and, at a new tile, its features
// into the other of two buffers. A resident forest is copied once per block.
// Features sit in shared memory feature-major (x[f * rows + r]): the 32
// threads of a warp read 32 consecutive words whatever features their nodes
// pick. Each thread walks four trees at once, as many steps as the deepest
// of them (four independent load chains with no branch between them), and
// adds their leaf values to one float32 accumulator with __fadd_rn in
// ascending tree order: the same sum as sequential_tree_sum and the TPU
// kernel's caller.
//
// Bound on this card: bytes, by chip_smoke.py's count: each feature read
// once, each margin written once, the tables once — 20.9 MB per 262,144-row
// chunk at F = 19, 6.3 us at 3.35 TB/s. The work is depth node steps per
// (row, tree): 157 M for 100 trees of depth 6 on 262,144 rows, each a
// dependent pair of shared-memory loads. What this design runs into is the
// shared-memory pipe. Per 32 node steps (one warp's step of one tree): one
// wavefront for the feature word (conflict free), and for the 8-byte record
// two at the top levels (a 64-bit load is served a half-warp at a time) and
// about four and six at the 32- and 64-node levels, where a half-warp's
// nodes collide in banks: about 26 wavefronts and 13 shared loads per
// 6-level tree on a warp, some 4.3 wavefronts per 32 steps; at one
// wavefront per SM and clock, about 90 us per 262,144-row chunk on 132 SMs.
// The card shows about 1.6x that (PERF.md, Findings), and records
// split into two 4-byte arrays — fewer wavefronts, three loads a step —
// ran slower: the rate of shared load instructions sets the pace as much as
// their wavefronts. Fewer loads per step is the lever left.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 512;
constexpr int kTrees = 4;  // trees each thread walks at once

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the one committed last has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A node record: in shared memory 8 bytes with a 15-bit child slot, in a
// global chunk 16 bytes read with __ldg and a 32-bit child slot.
template <bool kGlobal> struct Rec;
template <> struct Rec<false> {
  using T = int2;
  static __device__ __forceinline__ int2 load(const int2* tab, int i) { return tab[i]; }
  static __device__ __forceinline__ int child(int2 r) { return r.y >> 16; }
};
template <> struct Rec<true> {
  using T = int4;
  static __device__ __forceinline__ int4 load(const int4* tab, int i) { return __ldg(tab + i); }
  static __device__ __forceinline__ int child(int4 r) { return r.z; }
};

// Trees [t_begin, t_end) of the chunk in `tab` for the row whose features
// start at xr (stride `rows`; row f = n_features holds -inf), added to acc in
// ascending tree order. Each group of kTrees walks takes as many steps as its
// deepest tree: a step has no branch, and a leaf's step lands on the leaf
// itself (its feature is the -inf row, its default bit set: -inf > value is
// false), so the group's loads interleave. A group short of kTrees trees
// repeats its last tree and does not add it.
template <bool kGlobal>
__device__ __forceinline__ float walk_chunk(const typename Rec<kGlobal>::T* __restrict__ tab,
                                            const float* xr, int rows,
                                            const int2* __restrict__ tree_info, int t_begin, int t_end,
                                            float acc) {
  using R = Rec<kGlobal>;
  for (int t0 = t_begin; t0 < t_end; t0 += kTrees) {
    int base[kTrees];
    typename R::T rec[kTrees];
    int depth = 0;
#pragma unroll
    for (int j = 0; j < kTrees; ++j) {
      const int2 info = __ldg(tree_info + min(t0 + j, t_end - 1));  // (root slot, depth)
      base[j] = info.x;
      depth = max(depth, info.y);
      rec[j] = R::load(tab, base[j]);
    }
    for (int d = 0; d < depth; ++d) {
#pragma unroll
      for (int j = 0; j < kTrees; ++j) {
        const int y = rec[j].y;
        const float v = xr[(y & 0x7fff) * rows];
        const float thr = __int_as_float(rec[j].x);
        const bool right = (y & 0x8000) ? (v > thr) : !(v <= thr);
        rec[j] = R::load(tab, base[j] + R::child(rec[j]) + (right ? 1 : 0));
      }
    }
#pragma unroll
    for (int j = 0; j < kTrees; ++j)
      if (t0 + j < t_end) acc = __fadd_rn(acc, __int_as_float(rec[j].x));
  }
  return acc;
}

__global__ void __launch_bounds__(kMaxRows)
forest_wide_margin_kernel(const float* __restrict__ x, long long n, int f,
                          const int2* __restrict__ records,    // (S, 2)
                          const int2* __restrict__ tree_info,  // (T,) root slot in its chunk, depth
                          const int* __restrict__ chunk_tree,  // (K + 1,)
                          const int* __restrict__ chunk_rec,   // (K + 1,), even
                          const int* __restrict__ chunk_global,  // (K,): read from device memory
                          int n_chunks, int chunk_records, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  const bool resident = n_chunks == 1;
  int2* const fbuf0 = reinterpret_cast<int2*>(smem);
  int2* const fbuf1 = resident ? fbuf0 : fbuf0 + chunk_records;
  float* const xbuf0 = reinterpret_cast<float*>(fbuf1 + chunk_records);
  float* const xbuf1 = xbuf0 + (long long)(f + 1) * rows;
  const float neg_inf = __int_as_float(0xff800000);
  xbuf0[f * rows + threadIdx.x] = neg_inf;  // the leaves' feature row, never copied over
  xbuf1[f * rows + threadIdx.x] = neg_inf;

  const long long n_tiles = (n + rows - 1) / rows;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long items = my_tiles * n_chunks;  // (tile, chunk) pairs, chunks innermost

  // copies for pair `item` into its buffers; one commit group per call (may be empty)
  auto prefetch = [&](long long item) {
    if (item < items) {
      const long long j = item / n_chunks;
      const int c = (int)(item - j * n_chunks);
      if (!chunk_global[c] && (!resident || item == 0)) {
        const int4* src = reinterpret_cast<const int4*>(records + chunk_rec[c]);
        int4* dst = reinterpret_cast<int4*>((item & 1) ? fbuf1 : fbuf0);
        const int count = (chunk_rec[c + 1] - chunk_rec[c]) / 2;
        for (int k = threadIdx.x; k < count; k += rows) cp_async_16(dst + k, src + k);
      }
      if (c == 0) {
        // rows fastest: a warp writes 32 consecutive words of one feature
        const long long row0 = (blockIdx.x + j * gridDim.x) * rows;
        const int nr = (int)min((long long)rows, n - row0);
        const float* src = x + row0 * f;
        float* dst = (j & 1) ? xbuf1 : xbuf0;
        for (int k = threadIdx.x; k < nr * f; k += rows) {
          const int ff = k / nr, r = k - ff * nr;
          cp_async_4(dst + ff * rows + r, src + (long long)r * f + ff);
        }
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  float acc = 0.0f;
  for (long long item = 0; item < items; ++item) {
    prefetch(item + 1);  // into the buffers of pair item - 1, which every thread has left
    cp_async_wait_prior();
    __syncthreads();  // pair item's copies, made by all threads, are visible
    const long long j = item / n_chunks;
    const int c = (int)(item - j * n_chunks);
    const long long row = (blockIdx.x + j * gridDim.x) * rows + threadIdx.x;
    if (c == 0) acc = 0.0f;
    if (row < n) {
      const float* xr = ((j & 1) ? xbuf1 : xbuf0) + threadIdx.x;
      if (chunk_global[c]) {
        const int4* tab = reinterpret_cast<const int4*>(records + chunk_rec[c]);
        acc = walk_chunk<true>(tab, xr, rows, tree_info, chunk_tree[c], chunk_tree[c + 1], acc);
      } else {
        const int2* tab = (resident || !(item & 1)) ? fbuf0 : fbuf1;
        acc = walk_chunk<false>(tab, xr, rows, tree_info, chunk_tree[c], chunk_tree[c + 1], acc);
      }
      if (c == n_chunks - 1) out[row] = acc;
    }
    __syncthreads();  // pair item's buffers may be overwritten
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" {

// Once per device, on the current device: its SM count and the shared memory
// a block may opt in to, which the kernel is then allowed to use. Returns the
// cudaError_t (0 = success).
int forest_wide_prepare(int* sm_count, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(forest_wide_margin_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_optin);
}

// Launches `grid` blocks of `rows` threads with `smem` bytes of shared memory
// (the wrapper's plan) on `stream`; returns the cudaError_t of the launch.
int forest_wide_margin(const float* x, long long n, int f, const void* records,
                       const void* tree_info, const int* chunk_tree, const int* chunk_rec,
                       const int* chunk_global, int n_chunks, int chunk_records, int rows, int grid,
                       int smem, float* out, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || rows > kMaxRows || rows % 32 != 0 || grid <= 0 || chunk_records % 2 != 0)
    return (int)cudaErrorInvalidValue;
  forest_wide_margin_kernel<<<grid, rows, (size_t)smem, (cudaStream_t)stream>>>(
      x, n, f, reinterpret_cast<const int2*>(records), reinterpret_cast<const int2*>(tree_info),
      chunk_tree, chunk_rec, chunk_global, n_chunks, chunk_records, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
