"""Run manifest: everything needed to reproduce/attribute a run, emitted
as the FIRST event of every obs stream.

Counterpart of ``variantcalling_tpu/obs/manifest.py``. The topology comes
from torch: ``backend`` is ``gpu`` where the run's device is a CUDA card
(else ``cpu``), with the card count, the card's name, one process and
rank 0.

The resume journal taught the shape (io/journal.py meta): a telemetry
stream whose header does not pin the configuration that produced it is
unattributable after the fact. The manifest records:

- the resolved **knob registry** — every ``VCTPU_*`` knob's typed value
  and whether it came from the environment or the declared default
  (``knobs.resolved()``; malformed knobs raised before obs started);
- **topology** — backend, device/process counts, rank, hostname, cpu
  count, the card's name;
- **input identity** — path, size, mtime_ns per labeled input (same
  signature the chunk journal binds to);
- the package **version** and the tool's argv.

Engine and forest-strategy decisions are NOT here: they resolve after
run start and land as ``resolve`` events in the stream, so the manifest
never claims a decision that was actually made later.
"""

from __future__ import annotations

import os
import socket

from variantcalling_tpu_torch import __version__, knobs


def _topology(device: str | None = None) -> dict:
    """``device``: the run's device as its entry point resolved it (None:
    the card where one is visible). A run on the CPU is described without
    importing torch (the fabric's router imports none)."""
    topo: dict = {
        "hostname": socket.gethostname(),
        "cpu_count": os.cpu_count() or 1,
    }
    if device is not None and not str(device).startswith("cuda"):
        topo.update(backend="cpu", devices=1, local_devices=1, process_count=1, process_index=0, device=str(device))
        return topo
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        on_card = count > 0 if device is None else str(device).startswith("cuda")
        topo.update(
            backend="gpu" if on_card else "cpu",
            devices=count if on_card else 1,
            local_devices=count if on_card else 1,
            process_count=1,
            process_index=0,
        )
        if on_card:
            topo["device_name"] = torch.cuda.get_device_name(0)
        if device is not None:
            topo["device"] = str(device)
    except Exception as e:  # noqa: BLE001 — an unusable CUDA runtime must not kill telemetry
        from variantcalling_tpu_torch.utils import degrade

        degrade.record("obs.topology_probe", e,
                       fallback="manifest topology omits the device fields")
    return topo


def _input_identity(inputs: dict[str, str] | None) -> dict:
    out: dict = {}
    for label, path in (inputs or {}).items():
        entry: dict = {"path": os.path.abspath(path)}
        try:
            st = os.stat(path)
            entry.update(size=int(st.st_size), mtime_ns=int(st.st_mtime_ns))
        except OSError:
            entry["missing"] = True
        out[label] = entry
    return out


def build_manifest(tool: str, argv: list[str] | None = None,
                   inputs: dict[str, str] | None = None,
                   device: str | None = None) -> dict:
    """The manifest event body (the envelope is added by the writer)."""
    return {
        "tool": tool,
        "version": __version__,
        "argv": list(argv) if argv is not None else None,
        "knobs": {name: {"value": value if isinstance(
                             value, (bool, int, float, str, type(None)))
                         else str(value),
                         "source": src}
                  for name, value, src in knobs.resolved()},
        "topology": _topology(device),
        "inputs": _input_identity(inputs),
    }
