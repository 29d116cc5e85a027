"""Build a kernel source of this directory into a shared library with ``nvcc``.

Each ``<name>.cu`` here has a plain C interface and is compiled on first
use for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``build/lib<name>-<hash>.so`` at the root of the checkout, where ``<hash>``
covers the source and the flags, so an edited source builds anew. An
installed package (no checkout around it) builds into
``$TORCH_EXTENSIONS_DIR/variantcalling_tpu_torch`` instead, else into
``~/.cache/variantcalling_tpu_torch``. The wrapper loads the library with
``ctypes``. Nothing is built when the module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
_CHECKOUT = SRC_DIR.parents[1]
if (_CHECKOUT / "pyproject.toml").exists():
    BUILD_DIR = _CHECKOUT / "build"
else:
    BUILD_DIR = Path(os.environ.get("TORCH_EXTENSIONS_DIR") or Path.home() / ".cache") \
        / "variantcalling_tpu_torch"
#: the kernel sources of this directory, by name
KERNELS = ("forest_wide", "forest_tree_step")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found on PATH or in /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Path of the built library for ``csrc/<name>.cu``, compiling it if needed.

    ``verbose`` echoes nvcc's output (ptxas register and shared-memory use) to stderr.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        sys.stderr.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    for arg in sys.argv[1:] or KERNELS:
        print(build(arg, verbose=True))
