// Shard-parallel execution for the native host engine.
//
// Every user splits its work into contiguous shards whose outputs land in
// disjoint ranges of preallocated buffers, so no locks are needed and the
// result is byte-identical to the serial path regardless of thread count.
//
// VCTPU_NATIVE_THREADS caps the shard count (default: hardware
// concurrency). On a single-core host the helpers degrade to a plain
// serial call with zero overhead.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace vctpu {

inline int nthreads() {
    const char* e = std::getenv("VCTPU_NATIVE_THREADS");
    long n = e ? std::strtol(e, nullptr, 10) : (long)std::thread::hardware_concurrency();
    if (n < 1) n = 1;
    if (n > 128) n = 128;
    return (int)n;
}

// Run f(shard, lo, hi) over [0, n) split into at most max_shards
// contiguous ranges of at least min_per_shard items each (small inputs
// stay serial: thread create+join dwarfs the work below a few thousand
// items — e.g. hundreds of decoy contigs with a handful of variants
// each). Shard 0 runs on the calling thread. Thread-spawn failure
// (bad_alloc / pid-limit system_error) degrades to running the
// unspawned shards serially — no exception ever crosses the caller's
// extern "C" boundary from here. Returns the number of shards used.
template <class F>
inline int for_shards(int64_t n, int max_shards, F&& f, int64_t min_per_shard = 4096) {
    int t_count = max_shards;
    if (min_per_shard > 0 && (int64_t)t_count > n / min_per_shard)
        t_count = (int)std::max<int64_t>(n / min_per_shard, 1);
    if ((int64_t)t_count > n) t_count = n > 0 ? (int)n : 1;
    if (t_count <= 1) {
        f(0, (int64_t)0, n);
        return 1;
    }
    const int64_t per = (n + t_count - 1) / t_count;
    std::vector<std::thread> workers;
    int64_t unspawned_lo = -1;
    try {
        workers.reserve(t_count - 1);
        for (int t = 1; t < t_count; ++t) {
            const int64_t lo = (int64_t)t * per;
            const int64_t hi = std::min(n, lo + per);
            if (lo >= hi) break;
            try {
                workers.emplace_back([&f, t, lo, hi] { f(t, lo, hi); });
            } catch (...) {
                unspawned_lo = lo;  // run [lo, n) on this thread below
                break;
            }
        }
    } catch (...) {
        unspawned_lo = per;  // reserve() threw: nothing spawned yet
    }
    f(0, (int64_t)0, std::min(per, n));
    if (unspawned_lo >= 0 && unspawned_lo < n) {
        // shard indices don't matter to correctness (ranges define the
        // output split); reuse the failed shard's own ranges serially
        for (int64_t lo = unspawned_lo; lo < n; lo += per)
            f((int)(lo / per), lo, std::min(n, lo + per));
    }
    for (auto& w : workers) w.join();
    return t_count;
}

}  // namespace vctpu
