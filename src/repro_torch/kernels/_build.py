"""Build the CUDA sources under ``csrc/`` into shared libraries at first
use and load them with ctypes.

Each source compiles with ``nvcc`` for ``sm_90a`` into
``<checkout>/build/repro_torch/<name>-<hash>.so``; the hash covers the
source text and the compiler flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  The library is written under a
temporary name and renamed into place, so parallel processes that build
the same source at once never load a half-written file.  The sources have
a plain C interface and include no PyTorch headers, so a build takes
seconds.

Every call into a loaded library goes through :func:`call_on`, which makes
the tensors' card the current device for the call: what the C side does
on the current device (``cudaFuncSetAttribute``, occupancy and SM-count
queries, TMA descriptors) then acts on the card the tensors lie on,
whichever card the caller has current.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from source at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed on its content."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists.
    Raises ``RuntimeError`` with nvcc's output if the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, signatures: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, declaring each C
    function's ``(argtypes, restype)``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def call_on(dev: int, fn: Callable[..., int], *args) -> int:
    """``fn(*args)``, a C function of a library that :func:`load` gave,
    with CUDA device ``dev`` (an index) current: called directly when it
    already is, else inside ``torch.cuda.device(dev)``.  Returns its
    code."""
    if dev == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)
