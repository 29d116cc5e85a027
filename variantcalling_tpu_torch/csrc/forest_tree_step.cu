// Per-tree forest margin kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel _tree_step_kernel
// (variantcalling_tpu/models/forest_pallas.py:51), launched by _margin_pallas
// and driven by make_gemm_pallas_predictor. Per 512-row tile and one tree,
// trees innermost, that kernel computes the path-matrix chain of the `gemm`
// strategy on the MXU: the one-hot feature pick x @ a, the decision <= thr,
// the routing d @ m2 + c, the leaf match == plen, and out += hit @ value,
// accumulating the margin over the trees in order.
//
// This kernel keeps the routing as a contraction and runs it on the tensor
// cores: d is in {0, 1}, m2 in {-1, 0, 1}, so d @ m2 is an int8 product with
// exact int32 sums (mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32). A true
// decision enters as the int8 -1 (the byte of a set.le mask), so a sum is
// -(d @ m2) and a leaf is hit when it equals c - plen. Output: (N,) float32
// margins, bit for bit those of forest.predict_margin_gemm (the plain version).
//
// Tables (built once by the wrapper, models/forest_cuda.py
// tree_step_tables): each tree is scored in passes of 64 leaves (8 n-tiles of
// 8); a pass runs over the k-blocks (32 internal nodes) whose m2 block under
// its leaves is not all zero — a zero block adds 0 to every sum, and in
// to_gemm's depth-first order a pass of leaves reaches only its subtrees'
// nodes and their few ancestors. The forest is a sequence of units, each at
// most 16 k-blocks of one pass: per k-block 32 node entries (threshold bits,
// column) and the block's m2 as B fragments (lane l reads 16 bytes at
// (pair * 32 + l) * 16: two n-tiles' registers); the last unit of a pass ends
// with its leaf table (c - plen, value bits; a padded leaf 1, which its sum 0
// never equals). A node's column is its feature, plus F where its default
// branch is left: with default_left the feature rows hold x and then x with
// NaN read as -inf, so that v <= thr alone is the reference's
// isnan(v) ? dleft : v <= thr (-inf <= thr for any threshold; NaN <= thr
// never).
//
// Layout: one block per 32 * warps rows (4 warps where the shared memory
// allows), each warp 32 rows as two m16 tiles. The block stages its rows'
// features in shared memory (feature-major: a lane's four rows of a column sit
// at fixed offsets from one address; the stride, 32 * warps + 8 words, puts
// column c at bank 8 c modulo 32, and the tables order each k-block's nodes so
// that the four columns lanes q = 0..3 read in one load are equal or differ
// modulo 4 where the block allows: forest_cuda._bank_order), then streams the
// units through two shared-memory buffers with cp.async, a stage of units
// (about 16 KB) at a time, the next stage landing while the current one is
// computed. Per k-block each lane
//   1. decides the 2 rows x 8 nodes of each m-tile's A fragment straight from
//      the feature tile: one shared read of x[row, column], a compare and a
//      byte merge into the fragment's register;
//   2. multiplies them with the block's B fragments (one 16-byte shared load
//      per two n-tiles) into int32 accumulators, 16 mma per k-block.
// At a pass's end each lane compares its sums with the leaf table's c - plen
// and keeps the bits of the value of a hit; at a tree's end the four lanes of
// a quad combine theirs (exactly one leaf of a tree hits a row) and each row
// adds its tree's value with __fadd_rn, in ascending tree order: the same sum
// as sequential_tree_sum and the TPU kernel's out += s.
//
// Bound on this card: bytes, as for the wide kernel (the same function): per
// 262,144-row chunk at F = 19, 19.9 MB of features in and 1 MB of margins
// out. The dense contraction, 2 * N * sum(I_pad * L_pad) int8 operations at
// 1,979 TOPS, is 0.044 ms for 100 trees of 64 leaves at 104,000 rows: what
// this formulation can at best reach. What this design runs into is the
// decisions: 32 per lane per k-block, each a shared load, a compare and a
// byte merge, about six times the instructions of the 16 mma they feed;
// and for trees past 64 leaves, the decisions of a k-block are made again in
// every pass that reads it. wgmma would take B from shared memory without
// the per-lane fragment loads and run 64-row tiles asynchronously beside the
// decisions of the next k-block; with the decisions the larger cost, mma.sync
// is kept here.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMT = 2;             // m16 tiles a warp: 32 rows
constexpr int kNT = 8;             // n-tiles of 8 leaves a pass: 64 leaves
constexpr int kNodeBytes = 256;    // 32 node entries of a k-block
constexpr int kBlockBytes = 2304;  // node entries and B fragments of a k-block
constexpr int kFirst = 1 << 16, kLastPass = 1 << 17, kLastTree = 1 << 18;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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

// d += a (16 x 32 int8, row) * b (32 x 8 int8, col), int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMaxWarps * 32)
forest_tree_step_kernel(const float* __restrict__ x, long long n, int f, int columns,
                        const int4* __restrict__ blob,   // the units, 16-byte words
                        const int2* __restrict__ units,  // (U,): offset in blob, k-blocks | flags
                        const int4* __restrict__ stages, // (S,): offset in blob, 16-byte words, first unit, units
                        int n_stages, int stage_bytes, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const buf0 = smem;
  unsigned char* const buf1 = smem + stage_bytes;
  float* const xs = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  const int rows = blockDim.x;   // 32 a warp
  const int stride = rows + 8;   // feature-major rows; a column's four row groups at fixed offsets
  const long long row0 = (long long)blockIdx.x * rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // the fragments' group and thread in group

  // copies for stage s into buffer s & 1; one commit group per call (may be empty)
  auto prefetch = [&](int s) {
    if (s < n_stages) {
      const int4 st = __ldg(stages + s);
      const int4* src = blob + st.x;
      int4* dst = reinterpret_cast<int4*>((s & 1) ? buf1 : buf0);
      for (int k = threadIdx.x; k < st.y; k += rows) cp_async_16(dst + k, src + k);
    }
    cp_async_commit();
  };

  prefetch(0);
  const int nr = (int)min((long long)rows, n - row0);
  const float* xt = x + row0 * f;
  const float neg_inf = __int_as_float(0xff800000);
  for (int k = threadIdx.x; k < rows * f; k += rows) {
    const int r = k / f, c = k - r * f;
    const float v = r < nr ? xt[k] : 0.0f;
    xs[c * stride + r] = v;
    if (columns > f) xs[(f + c) * stride + r] = isnan(v) ? neg_inf : v;  // the default-left columns
  }
  // column c of rows warp * 32 + mt * 16 + hr * 8 + g at xw[c * stride + mt * 16 + hr * 8]
  const float* xw = xs + warp * 32 + g;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  unsigned pick[kMT][2] = {};  // bits of the hit leaf's value of the current tree, or 0
  float total[kMT][2] = {};

  for (int s = 0; s < n_stages; ++s) {
    prefetch(s + 1);  // into the buffer of stage s - 1, which every thread has left
    cp_async_wait_prior();
    __syncthreads();  // stage s's copies (and the feature tile), made by all threads, are visible
    const int4 st = __ldg(stages + s);
    for (int u = st.z; u < st.z + st.w; ++u) {
      const int2 h = __ldg(units + u);
      const int nk = h.y & 0xffff;
      const unsigned char* buf = ((s & 1) ? buf1 : buf0) + (h.x - st.x) * 16;
      if (h.y & kFirst) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
      }
#pragma unroll 2
      for (int kb = 0; kb < nk; ++kb) {
        const unsigned char* blk = buf + kb * kBlockBytes;
        const int4* nd = reinterpret_cast<const int4*>(blk);
        // A fragment registers: 0 row g, nodes 4q..4q+3; 1 row g + 8, the same
        // nodes; 2 row g, nodes 16 + 4q..; 3 row g + 8, nodes 16 + 4q..
        unsigned a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = 0u;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int4 two = nd[half * 8 + q * 2 + pr];  // nodes 16 half + 4q + 2pr, +1: (thr, column) each
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float thr = __int_as_float(e ? two.z : two.x);
              const float* xc = xw + (e ? two.w : two.y) * stride;
              const unsigned byte = 0xffu << (8 * (pr * 2 + e));  // the int8 -1 of a true decision
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) a[mt][hr + 2 * half] |= xc[mt * 16 + hr * 8] <= thr ? byte : 0u;
            }
          }
        }
        const int4* bf = reinterpret_cast<const int4*>(blk + kNodeBytes);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          const int4 b = bf[p * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_s8(acc[mt][2 * p], a[mt], (unsigned)b.x, (unsigned)b.y);
            mma_s8(acc[mt][2 * p + 1], a[mt], (unsigned)b.z, (unsigned)b.w);
          }
        }
      }
      if (h.y & kLastPass) {  // the leaf pick: sums c0, c1 (row g) and c2, c3 (row g + 8), leaves 2q, 2q + 1
        const int4* leaves = reinterpret_cast<const int4*>(buf + nk * kBlockBytes);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int4 lf = leaves[j * 4 + q];  // (c - plen, value bits) of leaves 8j + 2q, 8j + 2q + 1
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {  // at most one leaf of a tree hits a row
            if (acc[mt][j][0] == lf.x) pick[mt][0] = (unsigned)lf.y;
            if (acc[mt][j][1] == lf.z) pick[mt][0] = (unsigned)lf.w;
            if (acc[mt][j][2] == lf.x) pick[mt][1] = (unsigned)lf.y;
            if (acc[mt][j][3] == lf.z) pick[mt][1] = (unsigned)lf.w;
          }
        }
      }
      if (h.y & kLastTree) {  // one lane of the quad holds the hit: combine, add in tree order
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            unsigned bits = pick[mt][hr];
            bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
            bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
            total[mt][hr] = __fadd_rn(total[mt][hr], __uint_as_float(bits));
            pick[mt][hr] = 0u;
          }
      }
    }
    __syncthreads();  // stage s's buffer may be overwritten
  }
  cp_async_wait_all();
  if (q == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long row = row0 + warp * 32 + mt * 16 + hr * 8 + g;
        if (row < n) out[row] = total[mt][hr];
      }
  }
}

}  // namespace

extern "C" {

// Once per device, on the current device: its SM count and the shared memory
// a block may opt in to, which the kernel is then allowed to use. Returns the
// cudaError_t (0 = success).
int forest_tree_step_prepare(int* sm_count, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(forest_tree_step_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_optin);
}

// Launches `grid` blocks of `warps` warps with `smem` bytes of shared memory
// (the wrapper's plan) on `stream`; returns the cudaError_t of the launch.
int forest_tree_step_margin(const float* x, long long n, int f, int columns, const void* blob,
                            const void* units, const void* stages, int n_stages, int stage_bytes, int warps,
                            int grid, int smem, float* out, void* stream) {
  if (n <= 0) return 0;
  if (warps <= 0 || warps > kMaxWarps || grid <= 0 || n_stages <= 0 || stage_bytes % 16 != 0 ||
      (columns != f && columns != 2 * f))
    return (int)cudaErrorInvalidValue;
  forest_tree_step_kernel<<<grid, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
      x, n, f, columns, reinterpret_cast<const int4*>(blob), reinterpret_cast<const int2*>(units),
      reinterpret_cast<const int4*>(stages), n_stages, stage_bytes, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
