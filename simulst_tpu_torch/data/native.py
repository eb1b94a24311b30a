"""ctypes bridge to the native batched feature loader (data/dataloader.cpp,
a copy of the JAX package's native/dataloader.cpp; counterpart of
simulst_tpu/data/native.py `load_feature_batch`).

The C++ source is compiled with g++ at first use into
`simulst_tpu_torch/_build/libdataloader_<hash>.so` (the hash of the source
and flags, so an edited source rebuilds), written under a temporary name
and renamed, so that processes building at once never load a partial
file.  A build or load failure raises, as does a spec that is not a zip
member or an utterance the loader cannot read: the JAX package returns
None there and falls back to numpy; this package reads plain .npy specs
with numpy in data/dataset.py and zip members only here.  The JAX
package's native fbank (native/fbank.cpp) is not ported: no path calls
it, and ops/fbank computes the fbank on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
CMVN_MODES = {"none": 0, "utterance": 1, "global": 2}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libdataloader_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loader's shared library, built first if it is not there."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                                   f"{res.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    lp = ctypes.POINTER(ctypes.c_long)
    lib.load_feature_batch.restype = ctypes.c_int
    lib.load_feature_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), lp, lp, ctypes.c_int, fp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, fp,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    return lib


def is_zip_spec(spec: str) -> bool:
    """'path:offset:length', a member of a feature zip."""
    parts = spec.rsplit(":", 2)
    return len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit()


def load_feature_batch(specs, out: np.ndarray, cmvn: str = "utterance",
                       global_stats=None, n_threads: int = 8) -> np.ndarray:
    """Read the zip-member .npy specs into the zeroed (B, T, F) fp32 buffer
    `out` (B >= len(specs)) in one threaded call, CMVN applied in C++
    (utterance statistics over the whole utterance, even where T cuts it).
    Returns each utterance's true row count (clip to T for lengths)."""
    for spec in specs:
        if not is_zip_spec(spec):
            raise ValueError(f"{spec!r} is not a zip member "
                             "(path:offset:length)")
    b, t, f = out.shape
    n = len(specs)
    if n > b or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous float32 (B, T, F) "
                         f"buffer with B >= {n}")
    parts = [s.rsplit(":", 2) for s in specs]
    fp = ctypes.POINTER(ctypes.c_float)
    mode = CMVN_MODES[cmvn]
    gm = gs = None
    if mode == CMVN_MODES["global"]:
        gm = np.ascontiguousarray(global_stats["mean"], np.float32)
        gs = np.ascontiguousarray(global_stats["std"], np.float32)
        if gm.shape != (f,) or gs.shape != (f,):
            raise ValueError(f"global CMVN stats of shape {gm.shape}, "
                             f"{gs.shape} for {f} features")
    rows = np.full((n,), -1, np.int32)
    library().load_feature_batch(
        (ctypes.c_char_p * n)(*[p[0].encode() for p in parts]),
        (ctypes.c_long * n)(*[int(p[1]) for p in parts]),
        (ctypes.c_long * n)(*[int(p[2]) for p in parts]), n,
        out.ctypes.data_as(fp), t, f, mode,
        None if gm is None else gm.ctypes.data_as(fp),
        None if gs is None else gs.ctypes.data_as(fp),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max(1, min(n_threads, os.cpu_count() or 1)))
    bad = [specs[i] for i in np.flatnonzero(rows < 0)]
    if bad:
        raise RuntimeError(f"the native loader could not read {bad[:3]} "
                           f"({len(bad)} of {n}): not a float32 C-order 2-D "
                           f".npy of {f} features, or unreadable")
    return rows
