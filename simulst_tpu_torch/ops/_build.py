"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

The sources are compiled at first use, on the machine with the card, into
one shared library with a plain C interface: one nvcc per source, all
started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o _build/<hash>/<source>.o csrc/<source>.cu

then one link, nvcc -shared -o _build/libsimulst_kernels_<hash>.so.
The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already built.  nvcc's
output (with ptxas' register and shared-memory report) is kept beside the
library as `<name>.log`.  Every C entry returns `cudaGetLastError()` after
its launches; `launch` raises on anything but 0.  Nothing here runs at
import time.  Several processes may call `build` at once (the ranks of a
parallel run): the first takes an exclusive lock on `<name>.lock` and
builds, the others wait for it and load its library (the lock goes with
its process, so a build that was cut off leaves none behind).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes understood by csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# a dropout site: seed (uint64), on flag, keep threshold (uint32), 1 / keep
_DROP = [ctypes.c_uint64, _I, ctypes.c_uint32, ctypes.c_float]
SIGNATURES = {
    # dtype, ln_res, act, x, ln_g, ln_b, w1, b1, w2, b2, y, partial, xn, h,
    # n_rows, dim, hidden, splits, dim_real, hidden_real, seed, act_on,
    # act_threshold, act_inv_keep, out_on, out_threshold, out_inv_keep,
    # stream
    "simulst_ffn": [_I] * 3 + [_P] * 11 + [_I] * 6 + _DROP + _DROP[1:] + [_P],
    # dtype, act, x, w1, b1, w2, dy, dx, grads, u, hd, du, g, dh, partial,
    # n_rows, dim, hidden, splits, dim_real, hidden_real, seed, act site,
    # out site, stream
    "simulst_ffn_bwd": [_I] * 2 + [_P] * 13 + [_I] * 6 + _DROP + _DROP[1:]
                       + [_P],
    # dtype, h, w, b, res, y, u, n_rows, din, dout, dout_real, period,
    # res_rows, path, dropout, seed, threshold, inv_keep, stream
    "simulst_linear_res": [_I] + [_P] * 6 + [_I] * 7 + _DROP[1:2] + _DROP[:1]
                          + _DROP[2:] + [_P],
    # dtype, h, w, dy, dh, grads, du, partial, n_rows, din, dout, dout_real,
    # period, res_rows, splits, dropout, seed, threshold, inv_keep, stream
    "simulst_linear_res_bwd": [_I] + [_P] * 7 + [_I] * 8 + [ctypes.c_uint64]
                              + _DROP[2:] + [_P],
    # dtype, q, k, v, kmask, out, lse, B, Tq, Tk, D, heads, hd_real, causal,
    # path, dropout, seed, threshold, inv_keep, stream
    "simulst_mha_fwd": [_I] + [_P] * 6 + [_I] * 9 + [ctypes.c_uint64]
                       + _DROP[2:] + [_P],
    # dtype, q, k, v, kmask, out, lse, dout, dq, dk, dv, delta, ds, B, Tq,
    # Tk, D, heads, hd_real, causal, dropout, seed, threshold, inv_keep,
    # stream
    "simulst_mha_bwd": [_I] + [_P] * 12 + [_I] * 8 + [ctypes.c_uint64]
                       + _DROP[2:] + [_P],
    # dtype, act, x, ln_g, ln_b, w1, b1, w2, dy, dx, grads, xn, stats, u,
    # hd, du, g, dn, dh, partial, n_rows, dim, hidden, splits, dim_real,
    # hidden_real, seed, act site, out site, stream
    "simulst_ln_ffn_bwd": [_I] * 2 + [_P] * 18 + [_I] * 6 + _DROP
                          + _DROP[1:] + [_P],
    # dtype, q3, k, v, lengths, kid, seg_eid, out, batch, ng, nq, dim,
    # heads, hd_real, seg, lc, rc, max_mem, G, tk, unit_cols, smem_bytes,
    # dropout, seed, threshold, inv_keep, stream
    "simulst_emformer_attn": [_I] + [_P] * 7 + [_I] * 14 + _DROP[1:2]
                             + _DROP[:1] + _DROP[2:] + [_P],
    # dtype, q3, k, v, lengths, kid, seg_eid, dout, dq, dk, dv, probs,
    # dk_part, dv_part, batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
    # max_mem, G, tk, unit_cols, smem_bytes, dropout, seed, threshold,
    # inv_keep, stream
    "simulst_emformer_attn_bwd": [_I] + [_P] * 13 + [_I] * 14 + _DROP[1:2]
                                 + _DROP[:1] + _DROP[2:] + [_P],
    # q3, k, v, lengths, kid, seg_eid, dout, dq, dk, dv, dk_part, dv_part,
    # then simulst_emformer_attn_bwd's ints, dropout and stream (bf16 only)
    "simulst_emformer_attn_bwd_tc": [_P] * 12 + [_I] * 14 + _DROP[1:2]
                                    + _DROP[:1] + _DROP[2:] + [_P],
    # dtype, xp, dy, dw, partial, batch, t_out, taps, dim, groups, splits,
    # stream
    "simulst_convpos_wgrad": [_I] + [_P] * 4 + [_I] * 6 + [_P],
    # em, can_skip, input_lengths, target_lengths, alphas, T, B, S, stream
    "simulst_ctc_alpha": [_P] * 5 + [_I] * 3 + [_P],
    # em, alphas, can_skip, input_lengths, target_lengths, scale, nll, d_em,
    # T, B, S, stream
    "simulst_ctc_d_em": [_P] * 8 + [_I] * 3 + [_P],
    # mismatches (one int64), stream
    "simulst_ctc_log1p_check": [_P, _P],
    # seed (96 floats), out (32 floats), steps, shuffles, stream
    "simulst_ctc_chain_probe": [_P, _P, _I, _I, _P],
    # prefix, denom, alphas, N, U, S, stream
    "simulst_alignment_fwd": [_P] * 3 + [_I] * 3 + [_P],
    # prefix, denom, alphas, g, d_prefix, d_denom, N, U, S, stream
    "simulst_alignment_bwd": [_P] * 6 + [_I] * 3 + [_P],
    # x, csum, alpha, out, delays, B, S, T, C, beta, stream
    "simulst_cif_integrate": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir / f"libsimulst_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/*.cu unless a library of the same sources exists
    (another source tree into another directory: tools/kernel_bitcheck.py)."""
    out = library_path(csrc, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():      # another process built it meanwhile
            _compile(csrc, out)
    return out


def _compile(csrc: Path, out: Path) -> None:
    objdir = out.with_suffix("")
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(csrc.glob("*.cu"))
    objs = [objdir / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
    out.with_suffix(".log").write_text("\n".join(logs))
    failed = [str(src.name) for src, p in zip(sources, procs)
              if p.returncode != 0]
    if failed or link.returncode != 0:
        raise RuntimeError(f"nvcc failed on {failed or 'the link'}:\n"
                           + "\n".join(logs)[-6000:])
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file


def open_library(path: Path, every_entry: bool = True) -> ctypes.CDLL:
    """Load a built library and declare its C entries' signatures; unless
    every_entry, skip those it lacks (another revision's build)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if not every_entry and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    return open_library(build())


def launch(name: str, *args) -> None:
    """Call C entry `name` and raise if it reports a CUDA error."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def sass_functions(sass: str) -> dict:
    """{mangled kernel name: its SASS} from `cuobjdump --dump-sass` of the
    library (a kernel built in several sources: their SASS one after the
    other)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out.setdefault(name, "")
        elif name is not None:
            out[name] += line + "\n"
    return out


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dropout_args(rate: float, seed: int):
    """(on, seed, keep threshold, 1 / keep) of one dropout site, as the C
    entries take them (ops/philox.py keep_threshold)."""
    from simulst_tpu_torch.ops.philox import keep_threshold
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, seed & (2 ** 64 - 1), keep_threshold(rate), 1.0 / (1.0 - rate)


def round_up(n: int, step: int) -> int:
    """The least multiple of `step` at or above n."""
    return -(-n // step) * step


def padded(t: torch.Tensor, *widths: int) -> torch.Tensor:
    """t zero-padded at the end of each of its last len(widths) axes to
    `widths` (how the wrappers hand the kernels a width they do not take:
    the next one they do, the real width passed beside it); t itself where
    nothing pads."""
    pad = []
    for size, want in zip(reversed(t.shape[t.ndim - len(widths):]),
                          reversed(widths)):
        pad += [0, want - size]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def unpadded(t: torch.Tensor, *widths: int) -> torch.Tensor:
    """The leading `widths` of t's last len(widths) axes, contiguous: what
    `padded` added, cut away; t itself where nothing was padded."""
    if tuple(t.shape[t.ndim - len(widths):]) == widths:
        return t
    return t[(..., *(slice(0, w) for w in widths))].contiguous()


def padded_groups(t: torch.Tensor, groups: int,
                  width: int) -> torch.Tensor:
    """(..., groups * w) -> (..., groups * width): each of the last axis'
    `groups` equal slices (attention heads, conv groups) zero-padded from w
    to `width`; t itself when w == width."""
    w = t.shape[-1] // groups
    if w == width:
        return t
    t = padded(t.reshape(*t.shape[:-1], groups, w), width)
    return t.reshape(*t.shape[:-2], groups * width)


def unpadded_groups(t: torch.Tensor, groups: int, w: int) -> torch.Tensor:
    """The inverse of `padded_groups`, contiguous: the first w entries of
    each of the last axis' `groups` slices; t itself where nothing was
    padded."""
    if t.shape[-1] == groups * w:
        return t
    t = unpadded(t.reshape(*t.shape[:-1], groups, t.shape[-1] // groups), w)
    return t.reshape(*t.shape[:-2], groups * w)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose data starts on a 16-byte boundary, which
    the kernels' 16-byte loads need (a view may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors; when not, the
    wrappers skip their autograd.Function (its host time shows at the
    1-40 row shapes of decoding)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_cuda(name: str, ref: torch.Tensor, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on ref's device
    with ref's dtype."""
    for key, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: {key} must be on {ref.device}, "
                             f"got {t.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
