"""Build and load the port's hand-written CUDA kernels.

The sources under ``eta_inversion_tpu_torch/csrc/`` have a plain C interface.
At first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/kernels/`` at the repository root, and loaded
with ``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# what the last build of each library reported: seconds, ptxas summary
build_info: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels are built from source at first use")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so
    unless it exists, then load it.  Raises on any build failure."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        paths = [CSRC / s for s in sources]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths:
            h.update(p.read_bytes())
        lib_path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.monotonic() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
            build_info[name] = {"seconds": secs, "log": proc.stderr + proc.stdout,
                                "path": str(lib_path)}
        else:
            build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)",
                                         "path": str(lib_path)})
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib

