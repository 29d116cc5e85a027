"""The CNV caller's copy-number Viterbi: the CUDA kernel, its wrapper and its plain version.

Counterpart of the HMM in ``viterbi_segment``
(``variantcalling_tpu/cnv/caller.py:57``), which the JAX package runs as
two XLA ``lax.scan`` loops (no Pallas kernel). Its forward pass is
sequential over the bins, up to millions of them: as torch ops issued from
Python that is several launches a bin, so on the card it is the
hand-written kernel ``csrc/cnv_viterbi.cu`` (count :data:`LAUNCHES`): one
warp a sequence, all of a genome's contigs in one launch.

Both versions compute, in float32 and in the reference's order (the
emission as XLA computes it: the division by the constant sigma rewritten
as a product by its float32 reciprocal)::

    emission(x) = -0.5 * (((x - means) * inv_sigma) ** 2)
    delta_0 = emission(obs[0]) + log_init
    cand = delta[:, None] + log_trans;  bp_t = argmax(cand, 0);  delta = max(cand, 0) + emission(obs[t])
    states[-1] = argmax(delta_T);  states[t] = bp_{t+1}[states[t+1]]

with the first index winning ties. :func:`hmm_params` builds means,
log_trans, log_init and inv_sigma on the host as the reference does
(float32; the logs are float64 logs rounded once, which is what XLA gives
for these constants). The kernel equals :func:`viterbi_plain` bit for bit
(``torch.equal``).

What bounds the kernel: latency, T dependent steps of the longest
sequence; its bytes (obs in, states out: 8 bytes a bin) and operations are
negligible beside that.

A CPU tensor gets the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: copy-number states (0..4)
K = 5
#: log2 ratio of copy number 0 (in place of -inf)
LOG2_FLOOR = -3.0
#: launches of the Viterbi kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_ARGTYPES = {
    # obs, offsets, n_seq, params, inv_sigma, bp, states, stream
    "cnv_viterbi": [_P, _P, ctypes.c_int, _P, ctypes.c_float, _P, _P, _P],
}


def _entry(name: str):
    """The C entry point ``name``, the source built and loaded at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from variantcalling_tpu_torch.csrc import build

            lib = ctypes.CDLL(str(build.build("cnv_viterbi")))
            for entry, argtypes in _ARGTYPES.items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            _LIB = lib
    return getattr(_LIB, name)


def state_means() -> np.ndarray:
    """log2(cn / 2) of each copy number, cn = 0 floored at -3 (float64)."""
    with np.errstate(divide="ignore"):
        m = np.log2(np.maximum(np.arange(K), 1e-9) / 2.0)
    return np.maximum(m, LOG2_FLOOR)


def hmm_params(sigma: float = 0.35, p_stay: float = 0.999) -> dict[str, np.ndarray | np.float32]:
    """The HMM's float32 constants: means (K,), log_trans (K, K) [from, to],
    log_init (K,) and inv_sigma (the float32 1 / float32 sigma)."""
    stay = np.where(np.eye(K, dtype=bool), np.float32(p_stay), np.float32((1.0 - p_stay) / (K - 1)))
    return {
        "means": state_means().astype(np.float32),
        "log_trans": np.log(stay.astype(np.float64)).astype(np.float32),
        "log_init": np.log(np.full(K, 1.0 / K, dtype=np.float32).astype(np.float64)).astype(np.float32),
        "inv_sigma": np.float32(1.0) / np.float32(sigma),
    }


def _check(obs: torch.Tensor, offsets: torch.Tensor) -> None:
    if obs.dtype != torch.float32 or obs.dim() != 1 or not obs.is_contiguous():
        raise ValueError(f"cnv_viterbi: obs must be contiguous float32 (N,), got {obs.dtype} {tuple(obs.shape)}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or len(offsets) < 1 or offsets.device.type != "cpu":
        raise ValueError(f"cnv_viterbi: offsets must be int64 (n_seq + 1,) on the host, got {offsets.dtype} "
                         f"{tuple(offsets.shape)} on {offsets.device}")
    if int(offsets[0]) != 0 or int(offsets[-1]) != obs.shape[0] or bool((offsets[1:] < offsets[:-1]).any()):
        raise ValueError(f"cnv_viterbi: offsets must rise from 0 to {obs.shape[0]}")


def viterbi_plain(obs: torch.Tensor, offsets: torch.Tensor, params: dict) -> torch.Tensor:
    """The kernel's plain version on ``obs``'s device: int32 states of each
    sequence ``obs[offsets[i]:offsets[i + 1]]``. The forward pass is a loop
    over the longest sequence's bins, all sequences side by side (a shorter
    one's delta frozen past its end); the backtrace walks the backpointers
    on the host."""
    _check(obs, offsets)
    dev = obs.device
    bounds = offsets.tolist()
    lens = np.diff(bounds)
    n_seq, t_max = len(lens), int(lens.max()) if len(lens) else 0
    states = np.zeros(obs.shape[0], dtype=np.int32)
    if t_max == 0:
        return torch.from_numpy(states).to(dev)
    means = torch.as_tensor(params["means"], device=dev)
    inv_sigma = torch.full((K,), float(params["inv_sigma"]), dtype=torch.float32, device=dev)
    log_trans = torch.as_tensor(params["log_trans"], device=dev)
    padded = torch.zeros(n_seq, t_max, dtype=torch.float32, device=dev)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        padded[i, : hi - lo] = obs[lo:hi]
    d = (padded[:, :, None] - means) * inv_sigma
    em = -0.5 * (d * d)  # (n_seq, t_max, K)
    live = torch.as_tensor(np.arange(t_max)[None, :] < lens[:, None], device=dev)[:, :, None]
    delta = em[:, 0] + torch.as_tensor(params["log_init"], device=dev)
    bp = torch.zeros(max(t_max - 1, 0), n_seq, K, dtype=torch.int8, device=dev)
    for t in range(1, t_max):
        best, arg = torch.max(delta[:, :, None] + log_trans, dim=1)
        delta = torch.where(live[:, t], best + em[:, t], delta)
        bp[t - 1] = arg
    last = torch.max(delta, dim=1).indices.cpu().numpy()
    bp_host = bp.cpu().numpy()
    for i, (lo, n) in enumerate(zip(bounds[:-1], lens)):
        if n == 0:
            continue
        s = int(last[i])
        states[lo + n - 1] = s
        rows = bp_host[: n - 1, i]
        for t in range(n - 2, -1, -1):
            s = int(rows[t, s])
            states[lo + t] = s
    return torch.from_numpy(states).to(dev)


def viterbi_launch(obs: torch.Tensor, offsets: torch.Tensor, params: dict) -> torch.Tensor:
    """The CUDA kernel on a card tensor: the states :func:`viterbi_plain` gives."""
    global LAUNCHES
    _check(obs, offsets)
    if obs.device.type != "cuda":
        raise ValueError(f"cnv_viterbi: the kernel runs on the card, not on {obs.device}")
    n = obs.shape[0]
    states = torch.empty(n, dtype=torch.int32, device=obs.device)
    n_seq = len(offsets) - 1
    if n == 0 or n_seq == 0:
        return states.zero_()
    packed = np.concatenate([params["means"], params["log_trans"].reshape(-1), params["log_init"]])
    dev_params = torch.from_numpy(packed.astype(np.float32)).to(obs.device)
    dev_offsets = offsets.to(obs.device)
    bp = torch.empty(n, K, dtype=torch.int8, device=obs.device)
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream(obs.device).cuda_stream
        err = _entry("cnv_viterbi")(obs.data_ptr(), dev_offsets.data_ptr(), n_seq, dev_params.data_ptr(),
                                    float(params["inv_sigma"]), bp.data_ptr(), states.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cnv_viterbi failed: cudaError_t {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return states


def viterbi_states(obs: torch.Tensor, offsets: torch.Tensor, params: dict) -> torch.Tensor:
    """int32 Viterbi states of each sequence: the kernel for a card tensor,
    the plain version for a CPU one."""
    if obs.device.type == "cpu":
        return viterbi_plain(obs, offsets, params)
    return viterbi_launch(obs, offsets, params)
