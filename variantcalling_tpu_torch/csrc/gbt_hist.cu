// The boosted-forest fit's (node, feature, bin) gradient histogram, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds these histograms in XLA,
// as one bf16 one-hot product on an accelerator (_hist_matmul,
// variantcalling_tpu/models/boosting.py:74) and as float32 segment sums on
// the CPU (_hist_scatter, boosting.py:114). Here the gradients arrive in
// fixed point (int64, scaled per tree by a power of two so that no sum can
// overflow; models/gbt_hist.py), so every sum is an integer sum: exact and
// the same in any order. The kernel therefore equals its plain version
// (an int64 index_add_ over the same flat ids) bit for bit on any input,
// and two fits on the card grow the same trees.
//
// What bounds it: bytes. Per level it must read the bin ids (N*F bytes),
// the node ids (4N) and the two gradient columns (16N) once, and write the
// (nodes, F, B, 2) int64 table once; the adds are one per (row, feature)
// and gradient. Design: the (node, feature) pairs of a level are cut into
// tiles whose sums fit the block's shared memory (one pair = B bins x 2 x 8
// bytes: 1 KiB at 64 bins); blockIdx.y picks the tile, blockIdx.x a range
// of rows. Consecutive threads take consecutive (row, feature) cells of the
// row-major bin matrix, so the byte loads coalesce and the lanes of a warp
// mostly add into different features' bins (fewer shared-atomic
// collisions than a thread per row). A cell whose node lies outside the
// block's tile is skipped. The tile's sums are built with 64-bit shared
// atomics and flushed with 64-bit global atomics into the zeroed output
// (non-zero cells only). Integer atomics make the result independent of
// the order the blocks and lanes run in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gbt_hist_kernel(const uint8_t* __restrict__ binned,   // (n, f) row-major bin ids < b
                                const int32_t* __restrict__ node_id,  // (n,) in [0, n_nodes)
                                const long long* __restrict__ gq,     // (n,) fixed-point gradients
                                const long long* __restrict__ hq,     // (n,) fixed-point hessians
                                long long n, int f, int b, int pairs, int tile_pairs, long long rows_per_block,
                                unsigned long long* __restrict__ out)  // (n_nodes * f, b, 2), zeroed
{
    extern __shared__ unsigned long long sums[];  // (tile_pairs, b, 2)
    const int p0 = blockIdx.y * tile_pairs;
    const int np = min(tile_pairs, pairs - p0);
    const int cells = np * b * 2;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) sums[i] = 0ull;
    __syncthreads();

    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min(n, r0 + rows_per_block);
    if (r0 < r1) {
        const uint8_t* bins = binned + r0 * f;
        const long long span = (r1 - r0) * f;  // cells of this block's rows
        for (long long j = threadIdx.x; j < span; j += blockDim.x) {
            const long long local = j / f;
            const int feat = (int)(j - local * f);
            const long long row = r0 + local;
            const int pair = node_id[row] * f + feat - p0;
            if ((unsigned)pair < (unsigned)np) {
                unsigned long long* cell = sums + ((long long)pair * b + bins[j]) * 2;
                atomicAdd(cell, (unsigned long long)gq[row]);
                atomicAdd(cell + 1, (unsigned long long)hq[row]);
            }
        }
    }
    __syncthreads();
    unsigned long long* dst = out + (long long)p0 * b * 2;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const unsigned long long v = sums[i];
        if (v) atomicAdd(dst + i, v);
    }
}

}  // namespace

extern "C" {

// The device's SM count and the shared memory a block may opt in to; lets
// the kernel use that much (cudaFuncSetAttribute). Returns a cudaError_t.
int gbt_hist_prepare(int* sm_count, int* smem_optin) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaFuncSetAttribute(gbt_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_optin);
}

// One level's histogram: grid (grid_x row ranges, grid_y pair tiles) of
// `threads` threads, `smem` bytes of dynamic shared memory each, on
// `stream`. Returns the launch's cudaError_t (0: queued).
int gbt_hist(const void* binned, const void* node_id, const void* gq, const void* hq, long long n, int f, int b,
             int pairs, int tile_pairs, long long rows_per_block, int grid_x, int grid_y, int threads, int smem,
             void* out, void* stream) {
    gbt_hist_kernel<<<dim3(grid_x, grid_y), threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)binned, (const int32_t*)node_id, (const long long*)gq, (const long long*)hq, n, f, b,
        pairs, tile_pairs, rows_per_block, (unsigned long long*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
