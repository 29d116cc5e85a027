// The CNV caller's copy-number Viterbi, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the HMM as two XLA
// lax.scan loops (viterbi_segment, variantcalling_tpu/cnv/caller.py:57),
// a forward pass over the bins and a backtrace. Issued as torch ops from
// Python that would be several launches a bin, over up to millions of
// bins, so here each sequence (a contig's bins) is one block:
//
//   delta_0[j] = emission_j(obs[0]) + log_init[j]
//   cand[i][j] = delta_{t-1}[i] + log_trans[i][j]
//   bp_t[j]    = argmax_i cand[i][j]   (the first index of the maximum)
//   delta_t[j] = max_i cand[i][j] + emission_j(obs[t])
//   emission_j(x) = -0.5 * (d * d),  d = (x - means[j]) * inv_sigma
//   states[T-1] = argmax_j delta_{T-1}[j]; states[t] = bp_{t+1}[states[t+1]]
//
// inv_sigma is the float32 1 / sigma: XLA rewrites the reference's division
// by the constant sigma into that product, so this is the reference's
// arithmetic. Every operation is written with the round-to-nearest
// intrinsics (__fsub_rn, __fmul_rn, __fadd_rn), in the reference's order,
// so nvcc contracts nothing into an FMA: the kernel gives the states of its
// plain version (cnv/viterbi_cuda.viterbi_plain) bit for bit.
//
// What bounds it: latency. The forward pass is T dependent steps (an add,
// a 5-way max, an add), the backtrace T dependent reads; the bytes (obs in,
// states out) and the operations are tiny beside them. Design: one warp a
// sequence, lane j < K holds delta[j]; each step broadcasts the K deltas
// with __shfl_sync (no shared-memory barrier), the observations arrive 32
// at a time in one coalesced load issued a chunk ahead and are handed out
// by shuffle, and the backpointers go to global memory as int8 (T x K).
// The backtrace stages TILE rows of them at a time in shared memory with
// coalesced loads, and lane 0 walks the tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 5;          // copy-number states
constexpr int TILE = 4096;    // backpointer rows staged in shared memory for the backtrace
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float emission(float x, float mean, float inv_sigma) {
    const float d = __fmul_rn(__fsub_rn(x, mean), inv_sigma);
    return __fmul_rn(-0.5f, __fmul_rn(d, d));
}

// argmax with the first index winning ties, NaN counted as the largest
// (the first NaN wins), as torch.max / jnp.argmax pick
__device__ __forceinline__ bool better(float c, float best) {
    return c > best || (c != c && best == best);
}

__global__ void __launch_bounds__(32) cnv_viterbi_kernel(
        const float* __restrict__ obs,        // all sequences back to back
        const long long* __restrict__ offsets,  // (n_seq + 1,) starts of the sequences in obs
        const float* __restrict__ params,     // means (K), log_trans (K x K, [from][to]), log_init (K)
        float inv_sigma,
        int8_t* __restrict__ bp,              // (total, K) scratch backpointers
        int32_t* __restrict__ states)         // (total,) out
{
    __shared__ int8_t tile[TILE * K];
    const long long t0 = offsets[blockIdx.x];
    const long long T = offsets[blockIdx.x + 1] - t0;
    if (T <= 0) return;
    const float* o = obs + t0;
    int8_t* b = bp + t0 * K;  // row t - 1 holds bp_t
    int32_t* s_out = states + t0;
    const int lane = threadIdx.x;
    const int j = lane < K ? lane : 0;
    const float mean = params[j];
    float lt[K];
#pragma unroll
    for (int i = 0; i < K; ++i) lt[i] = params[K + i * K + j];

    float cur = lane < T ? o[lane] : 0.f;
    float delta = __fadd_rn(emission(__shfl_sync(FULL, cur, 0), mean, inv_sigma), params[K + K * K + j]);
    for (long long base = 0; base < T; base += 32) {
        const float nxt = base + 32 + lane < T ? o[base + 32 + lane] : 0.f;  // the next chunk, in flight
        const int steps = (int)min(32ll, T - base);
        for (int k = base == 0 ? 1 : 0; k < steps; ++k) {
            const float e = emission(__shfl_sync(FULL, cur, k), mean, inv_sigma);
            float best = __fadd_rn(__shfl_sync(FULL, delta, 0), lt[0]);
            int arg = 0;
#pragma unroll
            for (int i = 1; i < K; ++i) {
                const float c = __fadd_rn(__shfl_sync(FULL, delta, i), lt[i]);
                if (better(c, best)) { best = c; arg = i; }
            }
            delta = __fadd_rn(best, e);
            if (lane < K) b[(base + k - 1) * K + lane] = (int8_t)arg;
        }
        cur = nxt;
    }

    int state = 0;
    {
        float best = __shfl_sync(FULL, delta, 0);
#pragma unroll
        for (int i = 1; i < K; ++i) {
            const float d = __shfl_sync(FULL, delta, i);
            if (better(d, best)) { best = d; state = i; }
        }
    }
    if (lane == 0) s_out[T - 1] = state;
    __syncthreads();  // the backpointers written above are visible to every lane
    for (long long hi = T - 1; hi > 0; hi -= TILE) {
        const long long lo = hi > TILE ? hi - TILE : 0;
        const int bytes = (int)(hi - lo) * K;
        for (int i = lane; i < bytes; i += 32) tile[i] = b[lo * K + i];
        __syncthreads();
        if (lane == 0) {
            for (long long t = hi - 1; t >= lo; --t) {
                state = tile[(t - lo) * K + state];
                s_out[t] = state;
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

// Viterbi states of n_seq sequences, one block of 32 threads each, on
// `stream`. Returns the launch's cudaError_t (0: queued).
int cnv_viterbi(const void* obs, const void* offsets, int n_seq, const void* params, float inv_sigma, void* bp,
                void* states, void* stream) {
    cnv_viterbi_kernel<<<n_seq, 32, 0, (cudaStream_t)stream>>>(
        (const float*)obs, (const long long*)offsets, (const float*)params, inv_sigma, (int8_t*)bp,
        (int32_t*)states);
    return (int)cudaGetLastError();
}

}  // extern "C"
