"""The boosted-forest fit's histogram kernel: fixed-point gradients, wrapper, plain version.

The fit (:mod:`models.boosting`) grows each tree level by level from the
sums of the gradients g and hessians h over the rows of every (node,
feature, bin). The JAX package sums them in XLA in float32 (a bf16 one-hot
product on an accelerator, segment sums on the CPU). Here they are summed
as integers: per tree, g and h are scaled by powers of two chosen from
their exact maxima so that no sum of the level can pass 2^62, rounded to
int64 the same way on every device (:func:`to_fixed`), and summed exactly.
Integer addition is associative, so the sums do not depend on the order
rows are added in: the CUDA kernel (``csrc/gbt_hist.cu``, count
:data:`LAUNCHES`) equals its plain version (:func:`hist_plain`, an int64
``index_add_``) bit for bit, and a fit on the card grows the trees the same
fit on the CPU grows. The scale is finer than float32 sums at millions of
rows (2^-38 of the largest gradient at 5 M rows).

A CPU tensor gets the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: launches of the histogram kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
#: (SM count, opt-in shared memory per block) by device index
_LIMITS: dict[int, tuple[int, int]] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "gbt_hist_prepare": [_P, _P],
    # binned, node_id, gq, hq, n, f, b, pairs, tile_pairs, rows_per_block, grid_x, grid_y, threads, smem, out, stream
    "gbt_hist": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I, _I, _I, _I, _P, _P],
}

#: the shared memory a block's tile of (node, feature) sums may take
TILE_BYTES = 96 * 1024
THREADS = 512
#: blocks a launch aims at per SM
BLOCKS_PER_SM = 2
#: the largest sum a level may reach, 2^62: no int64 add can overflow
SUM_BITS = 62
#: rows a slab of the plain version: its flat ids and values stay near 120 MB
_PLAIN_SLAB = 1 << 19


def _entry(name: str):
    """The C entry point ``name``, the source built and loaded at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from variantcalling_tpu_torch.csrc import build

            lib = ctypes.CDLL(str(build.build("gbt_hist")))
            for entry, argtypes in _ARGTYPES.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            _LIB = lib
    return getattr(_LIB, name)


def _device_limits(device: torch.device) -> tuple[int, int]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        sm_count, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _entry("gbt_hist_prepare")(ctypes.byref(sm_count), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"gbt_hist_prepare failed: cudaError_t {err}")
        _LIMITS[index] = (sm_count.value, smem.value)
    return _LIMITS[index]


def load(device: torch.device) -> None:
    """On the card: build and load the kernel's library and ask the device's
    limits, so that the fit's first launch does neither."""
    if device.type == "cuda":
        _device_limits(device)


def scale_exponent(a: torch.Tensor, n: int) -> torch.Tensor:
    """The int32 exponent k (a 0-d tensor on ``a``'s device) such that every
    value of ``a`` times 2^k is below 2^SUM_BITS / 2^ceil(log2 n) in
    magnitude: ``n`` of them sum below 2^SUM_BITS. From the exact maximum,
    on the device, with no host round trip."""
    top = a.abs().amax() if a.numel() else a.new_zeros(())
    _, e = torch.frexp(top)  # top < 2^e
    return (SUM_BITS - max(int(n) - 1, 0).bit_length() - e).to(torch.int32)


def to_fixed(g: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ghq, kg, kh): g and h (float32 (N,)) as one (2, N) int64 tensor of
    ``round(g * 2^kg)`` and ``round(h * 2^kh)`` (exact scaling by a power of
    two in float64, then round half to even), and the two exponents."""
    n = g.shape[0]
    kg, kh = scale_exponent(g, n), scale_exponent(h, n)
    ghq = torch.stack([torch.ldexp(g.double(), kg.double()), torch.ldexp(h.double(), kh.double())])
    return ghq.round_().to(torch.int64), kg, kh


def from_fixed(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Fixed-point sums back to float64: ``q * 2^-k`` (rounded once, in the
    int64 to float64 conversion)."""
    return torch.ldexp(q.double(), -k.double())


def _check(binned: torch.Tensor, node_id: torch.Tensor, ghq: torch.Tensor) -> None:
    n = binned.shape[0]
    if binned.dtype != torch.uint8 or binned.dim() != 2 or not binned.is_contiguous():
        raise ValueError(f"gbt_hist: binned must be contiguous uint8 (N, F), got {binned.dtype} "
                         f"{tuple(binned.shape)}")
    if node_id.dtype != torch.int32 or node_id.shape != (n,) or not node_id.is_contiguous():
        raise ValueError(f"gbt_hist: node_id must be contiguous int32 ({n},), got {node_id.dtype} "
                         f"{tuple(node_id.shape)}")
    if ghq.dtype != torch.int64 or ghq.shape != (2, n) or not ghq.is_contiguous():
        raise ValueError(f"gbt_hist: ghq must be contiguous int64 (2, {n}), got {ghq.dtype} {tuple(ghq.shape)}")
    if not (binned.device == node_id.device == ghq.device):
        raise ValueError(f"gbt_hist: inputs on {binned.device}, {node_id.device}, {ghq.device}")


def hist_plain(binned: torch.Tensor, node_id: torch.Tensor, ghq: torch.Tensor, n_nodes: int,
               n_bins: int) -> torch.Tensor:
    """The kernel's plain version: (n_nodes, F, n_bins, 2) int64 sums of
    ``ghq`` over the rows of each (node, feature, bin), as int64
    ``scatter_add_`` over the flat ids ``node*F*B + feature*B + bin``, in row
    slabs."""
    _check(binned, node_id, ghq)
    n, f = binned.shape
    out = torch.zeros(2, n_nodes * f * n_bins, dtype=torch.int64, device=binned.device)
    col = torch.arange(f, device=binned.device, dtype=torch.int64) * n_bins
    for lo in range(0, n, _PLAIN_SLAB):
        hi = min(n, lo + _PLAIN_SLAB)
        ids = (node_id[lo:hi, None].to(torch.int64) * (f * n_bins) + col + binned[lo:hi].to(torch.int64))
        ids = ids.reshape(-1)
        for k in range(2):
            out[k].scatter_add_(0, ids, ghq[k, lo:hi, None].expand(hi - lo, f).reshape(-1))
    return out.t().reshape(n_nodes, f, n_bins, 2)


def launch_plan(n: int, f: int, n_bins: int, n_nodes: int, sm_count: int, smem_optin: int
                ) -> tuple[int, int, int, int, int]:
    """(tile_pairs, rows_per_block, grid_x, grid_y, smem bytes) of one launch:
    tiles of as many (node, feature) pairs as TILE_BYTES (or the device's
    opt-in) holds, and row ranges enough for BLOCKS_PER_SM blocks an SM."""
    pairs = n_nodes * f
    pair_bytes = n_bins * 2 * 8
    budget = min(TILE_BYTES, smem_optin)
    if pair_bytes > budget:
        raise ValueError(f"gbt_hist: {n_bins} bins need {pair_bytes} bytes of shared memory a pair; "
                         f"the device allows {smem_optin}")
    tile_pairs = min(pairs, budget // pair_bytes)
    grid_y = -(-pairs // tile_pairs)
    grid_x = max(1, min(-(-BLOCKS_PER_SM * sm_count // grid_y), n))
    rows_per_block = -(-n // grid_x)
    return tile_pairs, rows_per_block, grid_x, grid_y, tile_pairs * pair_bytes


def hist_launch(binned: torch.Tensor, node_id: torch.Tensor, ghq: torch.Tensor, n_nodes: int,
                n_bins: int) -> torch.Tensor:
    """The CUDA kernel on card tensors: the same sums as :func:`hist_plain`."""
    global LAUNCHES
    _check(binned, node_id, ghq)
    if binned.device.type != "cuda":
        raise ValueError(f"gbt_hist: the kernel runs on the card, not on {binned.device}")
    n, f = binned.shape
    out = torch.zeros(n_nodes, f, n_bins, 2, dtype=torch.int64, device=binned.device)
    if n == 0:
        return out
    sm_count, smem_optin = _device_limits(binned.device)
    tile_pairs, rows_per_block, grid_x, grid_y, smem = launch_plan(n, f, n_bins, n_nodes, sm_count, smem_optin)
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        err = _entry("gbt_hist")(binned.data_ptr(), node_id.data_ptr(), ghq[0].data_ptr(), ghq[1].data_ptr(),
                                 n, f, n_bins, n_nodes * f, tile_pairs, rows_per_block, grid_x, grid_y, THREADS,
                                 smem, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gbt_hist failed: cudaError_t {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def gbt_hist(binned: torch.Tensor, node_id: torch.Tensor, ghq: torch.Tensor, n_nodes: int,
             n_bins: int) -> torch.Tensor:
    """(n_nodes, F, n_bins, 2) int64 (gradient, hessian) sums of a level: the
    kernel for card tensors, the plain version for CPU ones."""
    if binned.device.type == "cpu":
        return hist_plain(binned, node_id, ghq, n_nodes, n_bins)
    return hist_launch(binned, node_id, ghq, n_nodes, n_bins)
