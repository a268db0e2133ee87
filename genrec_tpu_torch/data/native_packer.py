"""ctypes bindings for the port's C++ batch packer (``native/packer.cpp``).

A copy of ``genrec_tpu/data/native_packer.py``: the same four entry points
over the same C ABI (version 1), behind the builders of
:mod:`genrec_tpu_torch.data.datasets`, whose Python paths give bit-identical
arrays. It differs in where the library comes from: at first use the port
compiles its own copy of the source with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` (no ``-march=native``: the library may run on another host than
the one that built it) into ``genrec_tpu_torch/_build/`` (listed in
``.gitignore``), named after a hash of the source and the flags, as
``ops/_build.py`` names the CUDA libraries. Nothing is built or loaded at
import, and no library of the JAX tree is ever loaded.

Without ``g++`` (and no library built before) :func:`available` is False
and the builders take their Python paths, as the reference's do without its
library. A failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "packer.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
ABI_VERSION = 1

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None  # the last compile's seconds in this process

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgenrec_native-{digest}.so")


def build() -> Optional[str]:
    """Compile the packer unless its library exists; its path, or None when
    there is no ``g++`` to build it with. A failed compile raises."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        cmd = [gxx, *CXX_FLAGS, SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for the native packer (rc {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: another process never loads a half-written file
        build_seconds = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _lib() -> Optional[ctypes.CDLL]:
    path = build()
    if path is None:
        return None
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(path)
    lib.genrec_native_abi_version.restype = ctypes.c_int32
    if lib.genrec_native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {lib.genrec_native_abi_version()}, "
                           f"expected {ABI_VERSION}")
    lib.pack_sasrec_train.argtypes = [_I32P, _I64P, ctypes.c_int64,
                                      ctypes.c_int32, _I32P, _I32P]
    lib.pack_sasrec_test.argtypes = [_I32P, _I64P, ctypes.c_int64,
                                     ctypes.c_int32, _I32P, _I32P]
    lib.pack_tiger.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                               _I32P, _I32P, _I32P]
    lib.pack_dense_t5_train.argtypes = [_I32P, _I64P, _I32P, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.pack_dense_t5_train.restype = ctypes.c_int64
    _loaded[path] = lib
    return lib


def available() -> bool:
    """Whether the packer loads (building it first if need be)."""
    return _lib() is not None


def _require() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native packer is not available: no g++ to build "
                           f"{SOURCE} with")
    return lib


def _flatten(seqs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat = (np.concatenate(seqs).astype(np.int32) if seqs
            else np.zeros(0, np.int32))
    return np.ascontiguousarray(flat), offsets


def pack_sasrec(seqs: List[np.ndarray], max_len: int, mode: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Native SASRec split pack. Caller pre-filters by min_seq_len."""
    lib = _require()
    flat, offsets = _flatten(seqs)
    n = len(seqs)
    inputs = np.zeros((n, max_len), np.int32)
    if mode == "train":
        targets = np.zeros((n, max_len), np.int32)
        lib.pack_sasrec_train(flat, offsets, n, max_len, inputs, targets)
    else:
        targets = np.zeros(n, np.int32)
        lib.pack_sasrec_test(flat, offsets, n, max_len, inputs, targets)
    return inputs, targets


def pack_tiger(histories: List[np.ndarray], targets: List[np.ndarray],
               max_len: int, code_dim: int, tgt_tokens: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _require()
    hflat, hoff = _flatten(histories)
    tflat, toff = _flatten(targets)
    n = len(histories)
    input_ids = np.zeros((n, max_len * code_dim), np.int32)
    mask = np.zeros((n, max_len * code_dim), np.int32)
    labels = np.zeros((n, tgt_tokens), np.int32)
    lib.pack_tiger(hflat, hoff, tflat, toff, n, max_len, code_dim,
                   tgt_tokens, input_ids, mask, labels)
    return input_ids, mask, labels


def pack_dense_t5_train(seqs: List[np.ndarray], user_ids: np.ndarray,
                        max_seq_len: int, min_seq_len: int = 2):
    lib = _require()
    flat, offsets = _flatten(seqs)
    uids = np.ascontiguousarray(np.asarray(user_ids, np.int32))
    n_users = len(seqs)
    total = lib.pack_dense_t5_train(flat, offsets, uids, n_users, max_seq_len,
                                    min_seq_len, None, None, None, None)
    hist = np.zeros((total, max_seq_len), np.int32)
    lens = np.zeros(total, np.int32)
    tgt = np.zeros(total, np.int32)
    out_uid = np.zeros(total, np.int32)
    lib.pack_dense_t5_train(
        flat, offsets, uids, n_users, max_seq_len, min_seq_len,
        hist.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        tgt.ctypes.data_as(ctypes.c_void_p),
        out_uid.ctypes.data_as(ctypes.c_void_p))
    return hist, lens, tgt, out_uid
