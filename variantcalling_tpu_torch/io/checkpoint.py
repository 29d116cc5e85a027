"""Training checkpoints of the DAN trainer, the port's stand-in for orbax.

The reference's ``train_dan`` saves ``{"params", "opt_state"}`` through an
orbax ``CheckpointManager`` (numeric step directories, ``max_to_keep=2``).
Here a step is one ``.npz`` file, ``dan_ckpt_step_<step>.npz``, holding
``step``, ``count`` (optax's int32 Adam count), ``params/<name>``,
``mu/<name>`` and ``nu/<name>`` as numpy. :func:`save` writes it to a
temporary file, fsyncs it, renames it into place and fsyncs the directory,
so a crash at any point leaves the previous checkpoint readable, then
keeps the newest :data:`KEEP` (2). A directory that holds orbax's numeric step
directories is refused (:class:`ForeignCheckpoint`): the port reads none of
it and writes nothing beside it.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from variantcalling_tpu_torch.models.dan import AdamState

PREFIX = "dan_ckpt_step_"
_NAME = re.compile(rf"^{PREFIX}(\d+)\.npz$")
_ORBAX_STEP = re.compile(r"^\d+(\.orbax-checkpoint-tmp-.*)?$")
KEEP = 2  # orbax's max_to_keep in the reference's train_dan


class ForeignCheckpoint(RuntimeError):
    """The directory holds a checkpoint the port cannot read (CLI exit 2)."""


def path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{PREFIX}{step:09d}.npz")


def check_not_orbax(ckpt_dir: str) -> None:
    """Raise :class:`ForeignCheckpoint` where ``ckpt_dir`` holds orbax step
    directories (the reference's ``train_dan`` wrote it)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(n for n in os.listdir(ckpt_dir)
                   if _ORBAX_STEP.match(n) and os.path.isdir(os.path.join(ckpt_dir, n)))
    if steps:
        raise ForeignCheckpoint(
            f"{ckpt_dir} holds an orbax checkpoint (step directories {steps[:4]}), which the port "
            "neither reads nor writes beside; give --checkpoint_dir a directory of its own")


def steps(ckpt_dir: str) -> list[int]:
    """The steps saved in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def latest(ckpt_dir: str) -> int | None:
    found = steps(ckpt_dir)
    return found[-1] if found else None


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, params: dict[str, torch.Tensor], opt_state: AdamState) -> str:
    """Write step ``step`` atomically, then remove all but the newest :data:`KEEP`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {"step": np.asarray(step, dtype=np.int64), "count": opt_state.count.numpy().astype(np.int32)}
    for group, tree in (("params", params), ("mu", opt_state.mu), ("nu", opt_state.nu)):
        for k, v in tree.items():
            arrays[f"{group}/{k}"] = v.detach().cpu().numpy()
    final = path(ckpt_dir, step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    for old in steps(ckpt_dir)[:-KEEP]:
        os.unlink(path(ckpt_dir, old))
    return final


def restore(ckpt_dir: str, step: int, device: torch.device | str = "cpu"
            ) -> tuple[dict[str, torch.Tensor], AdamState]:
    """(params, Adam state) of step ``step``; the tensors on ``device``, the
    count on the host."""
    trees: dict[str, dict[str, torch.Tensor]] = {"params": {}, "mu": {}, "nu": {}}
    with np.load(path(ckpt_dir, step), allow_pickle=False) as z:
        if int(z["step"]) != step:
            raise ValueError(f"{path(ckpt_dir, step)} holds step {int(z['step'])}")
        count = torch.tensor(int(z["count"]), dtype=torch.int32)
        for name in z.files:
            group, _, key = name.partition("/")
            if group in trees:
                trees[group][key] = torch.from_numpy(z[name]).to(device)
    return trees["params"], AdamState(count, trees["mu"], trees["nu"])
