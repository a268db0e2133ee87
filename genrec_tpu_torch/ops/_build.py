"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``genrec_tpu_torch/_build/`` (listed in ``.gitignore``), named after a
hash of the source and the headers beside it, so a changed source is never
served a stale library,
and loaded with ``ctypes``. ``build_all`` starts one ``nvcc`` per source,
all together. Nothing here runs when a module is imported:
the CPU tests import every module on a machine with no ``nvcc``.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, Tuple[float, str]] = {}  # name -> (seconds, nvcc output)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named after a hash of the source,
    every header in ``csrc/`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` whose library does not exist, one
    ``nvcc`` per source, all started together; return each library's path."""
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(out[name])]
    if not todo:
        return out
    nvcc = _nvcc()  # before any file is made: no compiler, nothing to clean up
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[name] = (proc, tmp, cmd, time.perf_counter())
        for name, (proc, tmp, cmd, t0) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, out[name])  # atomic: a reader never sees a half-written library
            build_log[name] = (time.perf_counter() - t0, log)
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library, once."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
