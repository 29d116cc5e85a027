"""train_dan: train the DAN variant filter on the card, with checkpoints and resume.

Counterpart of ``variantcalling_tpu/pipelines/train_dan.py``, with the
same arguments and defaults plus ``--backend gpu|cpu`` (default ``gpu``:
the card; asking for it without one exits 2):

- a chunked, journaled, resumable ingest of the concordance h5
  (:func:`ingest_streaming`): one chunk an h5 frame key, or row ranges of a
  single frame, each featurized chunk committed to an ingest cache under
  the run's identity fingerprint (``ingest.json``, ``ingest.manifest``,
  ``chunk_NNNNNN.npz``: the reference's layout and identity, so a cache that
  either package wrote is one the other resumes); an identity change
  restarts it;
- normalisation on the host by the reference's numpy calls (``norm_mu``
  and ``norm_sd`` byte-equal to its own);
- the training set uploaded once; each step's rows drawn on the host from
  ``np.random.default_rng(seed + start_step)`` as the reference draws them,
  sent to the card a window of steps at a time, and gathered there; the
  loss read back only at ``--log_every`` steps;
- checkpoints every ``--checkpoint_every`` steps (:mod:`io.checkpoint`, the
  newest two kept), and resume from the latest;
- the model saved through ``registry.save_models`` under
  :data:`MODEL_NAME`, in the reference's class names;
- with ``VCTPU_OBS=1``, the run's obs stream at
  ``<output_file_prefix>.obs.jsonl``: an ``ingest_chunk`` event a chunk, a
  ``step`` event a logged step (its loss, steps and rows a second) and the
  ``train.step_s`` histogram of each step's host time.

The port trains on one rank: ``VCTPU_RANK``/``VCTPU_NUM_PROCESSES``/
``VCTPU_SPAN`` asking for more exit 2 (multi-GPU is ROADMAP A7). Only h5
input is read; the reference's VCF path fails with an ``AttributeError``
(its parser lacks the VCF-mode arguments), and the port exits 2 with a
message instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch import engine as engine_mod
from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.io import checkpoint, hdf5
from variantcalling_tpu_torch.io import identity as identity_mod
from variantcalling_tpu_torch.models import dan
from variantcalling_tpu_torch.models.registry import save_models
from variantcalling_tpu_torch.utils.stages import stage
from variantcalling_tpu_torch.pipelines.train_models import H5_FEATURES, _exome_weight
from variantcalling_tpu_torch.utils.h5_utils import CONCORDANCE_SKIP_KEYS, Frame, list_keys, read_hdf

log = logging.getLogger(__name__)

MODEL_NAME = "dan_model_ignore_gt_incl_hpol_runs"

#: ingest journal schema version (the reference's): a change to the cached
#: chunk layout bumps it, so stale caches restart instead of misloading
_INGEST_VERSION = 1
#: a step's log line; its arguments: step, loss, steps a second since the last one
STEP_LOG = "step %d loss %.4f (%.1f step/s)"
#: the ingest's resume line; its arguments: chunks read from the cache, chunks
RESUMED_LOG = "ingest resumed %d/%d chunks from cache"
#: a resumed training run's line; its argument: the checkpoint's step
RESUME_STEP_LOG = "resumed from checkpoint step %d"
#: steps whose row indices are drawn on the host and sent to the card in one copy
INDEX_WINDOW = 256


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="train_dan", description=run.__doc__)
    ap.add_argument("--input_file", required=True, help="concordance h5 (run_comparison output)")
    ap.add_argument("--output_file_prefix", required=True)
    ap.add_argument("--list_of_contigs_to_read", nargs="*", default=None)
    ap.add_argument("--exome_weight", type=float, default=1.0)
    ap.add_argument("--exome_weight_annotation", default=None)
    ap.add_argument("--n_steps", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=1 << 14)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--embed_dim", type=int, default=16)
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="checkpoint dir (enables save/resume; also hosts the journaled ingest cache)")
    ap.add_argument("--checkpoint_every", type=int, default=200)
    ap.add_argument("--ingest_cache_dir", default=None,
                    help="journaled ingest cache dir (default: <checkpoint_dir>/ingest when checkpointing)")
    ap.add_argument("--ingest_chunk_rows", type=int, default=1 << 16,
                    help="row-range chunk size for single-frame inputs")
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbosity", default="INFO")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"], help="Execution backend")
    return ap.parse_args(argv)


def _split_features(x: np.ndarray, names: list[str]):
    """Feature matrix -> (numeric block, left/right motif code columns, numeric names)."""
    motif_cols = {"left_motif": None, "right_motif": None}
    numeric_idx = []
    for i, n in enumerate(names):
        if n in motif_cols:
            motif_cols[n] = i
        else:
            numeric_idx.append(i)
    numeric = x[:, numeric_idx]
    li, ri = motif_cols["left_motif"], motif_cols["right_motif"]
    left = x[:, li].astype(np.int32) if li is not None else np.zeros(len(x), np.int32)
    right = x[:, ri].astype(np.int32) if ri is not None else np.zeros(len(x), np.int32)
    left = np.clip(left, 0, dan.MOTIF_VOCAB - 1)
    right = np.clip(right, 0, dan.MOTIF_VOCAB - 1)
    return numeric.astype(np.float32), left, right, [names[i] for i in numeric_idx]


# -- the journaled ingest -----------------------------------------------------------


def _frame_to_training(df: Frame, args):
    """One frame chunk -> (x, names, label, weight): the rows of
    ``train_models``' h5 ingest (tp/fp kept, tp labeled 1, the recognised
    feature columns NaN-filled in float32, the exome weight)."""
    if args.list_of_contigs_to_read and "chrom" in df:
        df = df.take(np.isin(np.asarray([str(c) for c in df["chrom"]], dtype=object),
                             args.list_of_contigs_to_read))
    cls = df["classify"]  # strings, None where missing (equal to no class)
    keep = (cls == "tp") | (cls == "fp")
    df = df.take(keep)
    label = (cls[keep] == "tp").astype(np.float32)
    names = [f for f in H5_FEATURES if f in df]
    names += [c for c in df.columns if c.startswith(("LCR", "mappability", "exome", "ug_hcr"))]
    if len(df):
        x = np.stack([np.nan_to_num(np.asarray(df[f], dtype=np.float32)) for f in names], axis=1)
    else:
        x = np.zeros((0, len(names)), np.float32)
    return x, names, label, np.asarray(_exome_weight(args, names, x), np.float32)


def _ingest_units(args) -> tuple[list, str, Frame | None]:
    """The chunk axis of the input: ``(units, mode, frame)``, units being the
    h5 frame keys (``mode="keys"``, more than one key) or ``[lo, hi)`` row
    ranges of the one frame (``mode="rows"``; ``frame`` is it, read once)."""
    keys = [k for k in list_keys(args.input_file) if k not in CONCORDANCE_SKIP_KEYS and k != "all"]
    if len(keys) > 1:
        return keys, "keys", None
    df = read_hdf(args.input_file, key="all", skip_keys=CONCORDANCE_SKIP_KEYS)
    step = max(1, int(args.ingest_chunk_rows))
    return [[lo, min(lo + step, len(df))] for lo in range(0, max(len(df), 1), step)], "rows", df


def _read_unit(args, unit, mode: str, frame: Frame | None):
    """One ingest unit as (x, names, label, weight)."""
    if mode == "keys":
        return _frame_to_training(read_hdf(args.input_file, key=unit), args)
    return _frame_to_training(frame.take(np.arange(unit[0], unit[1])), args)


def _ingest_identity(args, units: list, mode: str) -> dict:
    """What makes a cached ingest chunk reusable: the reference's fields
    (input file, chunk cut, contigs, weighting, rank layout), the rank
    layout fixed at one rank."""
    return {
        "version": _INGEST_VERSION,
        "input": identity_mod.file_sig(args.input_file),
        "mode": mode,
        "units": [list(u) if isinstance(u, (list, tuple)) else u for u in units],
        "contigs": sorted(args.list_of_contigs_to_read or []),
        "exome_weight": [float(args.exome_weight), args.exome_weight_annotation],
        "ranks": [0, 1],
    }


def _open_cache(cache_dir: str, ident: dict) -> dict[int, str]:
    """The committed chunks of ``cache_dir`` under ``ident`` ({unit: path});
    a cache of another identity is emptied (logged field by field) and
    restarted under this one."""
    fp = identity_mod.fingerprint(ident)
    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, "ingest.json")
    journal = os.path.join(cache_dir, "ingest.manifest")
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as fh:
            old = json.load(fh)
        if old.get("fingerprint") != fp:
            log.info("ingest cache identity changed (%s): restarting ingest",
                     identity_mod.describe_mismatch(old.get("identity", {}), ident))
            for name in os.listdir(cache_dir):
                os.unlink(os.path.join(cache_dir, name))
    if not os.path.exists(meta_path):
        tmp = f"{meta_path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"fingerprint": fp, "identity": ident}, fh)
        os.replace(tmp, meta_path)
    done: dict[int, str] = {}
    if os.path.exists(journal):
        with open(journal, encoding="utf-8") as fh:
            for line in fh:
                rec = json.loads(line)
                chunk = os.path.join(cache_dir, rec["file"])
                if os.path.exists(chunk):
                    done[int(rec["i"])] = chunk
    return done


def _commit_chunk(cache_dir: str, i: int, part: tuple) -> None:
    """``chunk_<i>.npz`` written, fsynced and renamed into place, then its
    journal line appended and fsynced."""
    x, names, label, weight = part
    fname = f"chunk_{i:06d}.npz"
    path = os.path.join(cache_dir, fname)
    tmp = f"{path}.tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, x=x, names=np.asarray(names), label=label, weight=weight)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    with open(os.path.join(cache_dir, "ingest.manifest"), "a", encoding="utf-8") as fh:
        fh.write(json.dumps({"i": i, "file": fname, "rows": int(len(x))}) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def ingest_streaming(args):
    """The training rows, chunk by chunk: ``(x, names, label, weight)``.

    With a cache dir (``--ingest_cache_dir``, else ``<checkpoint_dir>/ingest``)
    each featurized chunk is committed as it is read, and a rerun reads the
    committed ones back instead of featurizing them again."""
    units, mode, frame = _ingest_units(args)
    ident = _ingest_identity(args, units, mode)
    cache_dir = args.ingest_cache_dir or (os.path.join(args.checkpoint_dir, "ingest") if args.checkpoint_dir
                                          else None)
    done = _open_cache(cache_dir, ident) if cache_dir else {}
    parts = []
    names: list[str] | None = None
    for i, unit in enumerate(units):
        t0 = time.monotonic()
        if i in done:
            with np.load(done[i], allow_pickle=False) as z:
                part = (z["x"], [str(s) for s in z["names"]], z["label"], z["weight"])
        else:
            part = _read_unit(args, unit, mode, frame)
            if cache_dir:
                _commit_chunk(cache_dir, i, part)
        if names is None:
            names = part[1]
        elif part[1] != names:
            raise SystemExit(f"ingest chunk {i} produced feature layout {part[1]} != {names} — the input's "
                             "frames disagree on columns")
        parts.append(part)
        if obs.active():
            obs.event("train", "ingest_chunk", i=i, rows=int(len(part[0])), cached=i in done,
                      seconds=round(time.monotonic() - t0, 4))
    resumed = sum(1 for i in range(len(units)) if i in done)
    if resumed:
        log.info(RESUMED_LOG, resumed, len(units))
    if not parts:
        return np.zeros((0, 0), np.float32), [], np.zeros(0, np.float32), np.zeros(0, np.float32)
    return (np.concatenate([p[0] for p in parts], axis=0), names or [],
            np.concatenate([p[2] for p in parts]), np.concatenate([p[3] for p in parts]))


# -- the run ---------------------------------------------------------------------------


def run(argv) -> int:
    """Train the DAN variant filter with checkpoint/resume and a journaled streaming ingest."""
    args = parse_args(argv)
    logging.getLogger("variantcalling_tpu_torch").setLevel(getattr(logging, args.verbosity))
    try:
        knobs.validate_all()
        device = device_mod.resolve(args.backend)
    except (engine_mod.EngineError, device_mod.DeviceUnavailable) as e:
        log.error("%s", e)
        return 2
    ranks = device_mod.multi_rank()
    if ranks:
        log.error("train_dan: %s asks for more than one rank; the port trains on one (multi-GPU training is "
                  "ROADMAP A7) and never trains one rank on the whole input: unset them", ranks)
        return 2
    if not args.input_file.endswith((".h5", ".hdf", ".hdf5")):
        log.error("train_dan reads a concordance h5 (.h5, .hdf, .hdf5); %s is not one (VCF training is not a "
                  "path of the reference's train_dan either)", args.input_file)
        return 2
    # the run's telemetry stream (VCTPU_OBS=1): the ingest chunks, the
    # logged steps and the step-time histogram
    obs_run = obs.start_run("train_dan", default_path=str(args.output_file_prefix) + ".obs.jsonl", argv=argv,
                            inputs={"input": args.input_file}, device=str(device))
    status = "error"
    try:
        try:
            if args.checkpoint_dir:
                checkpoint.check_not_orbax(args.checkpoint_dir)
            rc = _run_impl(args, device)
        except (hdf5.H5Unsupported, checkpoint.ForeignCheckpoint, engine_mod.EngineError) as e:
            log.error("%s", e)
            rc = 2
        status = "ok" if rc == 0 else f"exit {rc}"
        return rc
    except BaseException as e:
        status = f"error: {type(e).__name__}"
        raise
    finally:
        obs.end_run(obs_run, status)


def _restored(args, cfg: dan.DanConfig, params: dict, device: torch.device):
    """(params, Adam state, start step) of the newest checkpoint, or None; a
    checkpoint of another shape raises :class:`engine.EngineError`."""
    latest = checkpoint.latest(args.checkpoint_dir)
    if latest is None:
        return None
    got, state = checkpoint.restore(args.checkpoint_dir, latest, device)
    want = {k: tuple(v.shape) for k, v in params.items()}
    have = {k: tuple(v.shape) for k, v in got.items()}
    if have != want or {k: tuple(v.shape) for k, v in state.mu.items()} != want:
        raise engine_mod.EngineError(f"checkpoint step {latest} in {args.checkpoint_dir} holds parameters {have}, "
                                     f"not this run's {want}")
    log.info(RESUME_STEP_LOG, latest)
    return got, state, latest + 1


def _run_impl(args, device: torch.device) -> int:
    with stage("ingest"):
        x, names, label, weight = ingest_streaming(args)
    if not len(label):
        raise engine_mod.EngineError(f"{args.input_file}: no tp/fp rows to train on")
    with stage("normalise"):
        numeric, left, right, numeric_names = _split_features(x, names)
        del x
        mu = numeric.mean(axis=0)
        sd = np.maximum(numeric.std(axis=0), 1e-6)
        numeric = (numeric - mu) / sd

    cfg = dan.DanConfig(n_numeric=numeric.shape[1], embed_dim=args.embed_dim, hidden=args.hidden,
                        n_layers=args.n_layers, learning_rate=args.learning_rate)
    params = dan.init_params(cfg, args.seed, device)
    opt_state = dan.adamw_init(params)
    start_step = 0
    if args.checkpoint_dir:
        restored = _restored(args, cfg, params, device)
        if restored is not None:
            params, opt_state, start_step = restored

    n = len(label)
    bs = min(args.batch_size, n)
    loss = torch.full((), float("nan"))
    with stage("train"):
        data = {"numeric": numeric, "motif_left": left.astype(np.int64), "motif_right": right.astype(np.int64),
                "label": label, "weight": weight.astype(np.float32)}
        data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in data.items()}
        rng = np.random.default_rng(args.seed + start_step)
        window_t0, window_start = time.monotonic(), start_step
        # host time of each step (no card synchronisation of its own)
        step_hist = obs.histogram("train.step_s")
        for lo in range(start_step, args.n_steps, INDEX_WINDOW):
            steps = range(lo, min(lo + INDEX_WINDOW, args.n_steps))
            idx = torch.from_numpy(np.stack([rng.integers(0, n, bs) for _ in steps])).to(device)
            for j, step in enumerate(steps):
                t0 = time.monotonic()
                batch = {k: v.index_select(0, idx[j]) for k, v in data.items()}
                params, opt_state, loss = dan.train_step(cfg, params, opt_state, batch)
                step_hist.observe(time.monotonic() - t0)
                if step % max(1, args.log_every) == 0:
                    value = float(loss)
                    steps_per_s = (step + 1 - window_start) / max(time.monotonic() - window_t0, 1e-9)
                    log.info(STEP_LOG, step, value, steps_per_s)
                    if obs.active():
                        obs.event("train", "step", step=step, loss=value, steps_per_s=round(steps_per_s, 3),
                                  rows_per_s=round(steps_per_s * bs, 1))
                    window_t0, window_start = time.monotonic(), step + 1
                if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
                    checkpoint.save(args.checkpoint_dir, step, params, opt_state)
        # in sorted order, as the reference's jitted step hands its dict back
        params_np = {k: params[k].detach().cpu().numpy() for k in sorted(params)}
        final_loss = float(loss)
    log.info("trained %d steps of %d rows on %s", max(args.n_steps - start_step, 0), bs, device)

    with stage("save"):
        model = dan.DanModel.from_params(cfg, params_np, feature_names=names, numeric_features=numeric_names)
        model.norm_mu, model.norm_sd = mu, sd
        save_models(args.output_file_prefix + ".pkl", {MODEL_NAME: model})
    log.info("final loss %.4f; model -> %s.pkl", final_loss, args.output_file_prefix)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
