"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in ``ops/csrc/*.cu`` expose a plain C interface (no PyTorch
headers), so ``nvcc`` builds each in seconds; the sources compile in
parallel, one ``nvcc`` each, and one more call links them, which keeps
the build short as sources are added. The shared library is built on
first use into ``stereo_depth_ruler_tpu_torch/_build/``, named by a
hash of the sources and flags, so a checkout with nothing built builds
everything the first time a kernel is launched. There is no fallback: a
missing ``nvcc`` or a failed build raises.

Pointers and the stream are passed as ``c_void_p`` (a plain Python int would
be cut to 32 bits); every entry returns ``cudaGetLastError()``, and
``check`` raises on a non-zero code. ``on_cuda``, ``require`` and
``stream`` are the wrappers' common dispatch and argument checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "check",
           "on_cuda", "require", "stream"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
# Compile flags. No --use_fast_math: division, expf and rintf stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # lt, rt, out, B, H, W, D, md, block, pair, stream
    "sdr_cost_box": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # C, S, B, H, W, D, dy, dx, P1, P2, acc, stream
    "sdr_sgm_pass": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # C, S (int16), B, H, W, D, dy, dx, P1, P2, acc, stream
    "sdr_sgm_pass_i16": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # lt, rt, C, S3, Lbuf, B, H, W, D, md, block, P1, P2, ndir, stream
    "sdr_cost_down": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # Sd, Su, Sh, out, B, H, W, D, md, uniq, quant16, disp12, apply_lr,
    # stream
    "sdr_wta_lr3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # in, out, A, D, B, esize, stream: (A, D, B) -> (B, D, A)
    "sdr_transpose_vol": [_P, _P, _I, _I, _I, _I, _P],
    # in, out, A, B, W, esize, stream: (A, B, W) -> (B, A, W)
    "sdr_transpose_leading": [_P, _P, _I, _I, _I, _I, _P],
    # in, out, D, H, W, esize, stream: (D, H, W) -> (W, D, H)
    "sdr_transpose_dhw": [_P, _P, _I, _I, _I, _I, _P],
    # S, out, B, H, W, D, md, uniq, quant16, disp12, apply_lr, mirror_from,
    # stream
    "sdr_wta_lr": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # disp, labels, B, H, W, max_diff, stream
    "sdr_speckle_labels": [_P, _P, _I, _I, _I, _F, _P],
    # disp, labels, sizes, out, B, H, W, max_size, stream
    "sdr_speckle_keep": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dl, dr, rhs, B, H, W, max_s, lrc_thresh, fill, stream
    "sdr_shift_gather_conf": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # guide, u, out, B, H, W, rows, lam, sigma, stream
    "sdr_fgs_pass": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # disp or labels, seed (null: labels mode), out, flags, B, H, W,
    # max_diff, max_iters, stream
    "sdr_sweep": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # key_in, val_in, key_out, val_out, key_tmp, val_tmp, hist, B, N, stream
    # (val pointers null: keys only)
    "sdr_radix_sort": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # N -> int32 histogram entries per frame that sdr_radix_sort needs
    "sdr_radix_hist_size": [_I],
    # skey, sidx, out, B, N, n_out, mode, max_size, L, slots, stream
    "sdr_sorted_runs": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _run_all(cmds) -> list:
    """Run the commands side by side; raise if any fails; return their
    outputs (stdout and stderr together)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return logs


def build() -> Path:
    """Build the kernel library if it is not built yet; return its path.
    The compiler's register and shared-memory report goes to a ``.log``
    file beside the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libsdr_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(_sources(), objs)])
        tmp = Path(work) / "lib.so"
        _run_all([[nvcc, *_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib)
    return lib


def load():
    """The loaded kernel library (built on first use), argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sdr_error_string.argtypes = [ctypes.c_int]
        lib.sdr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        msg = load().sdr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, "
                         f"got {sorted(kinds)}")
    return kinds == {"cuda"}


def require(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    """Raise unless t is a contiguous ndim-d tensor of dtype."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def stream() -> int:
    """The current CUDA stream's handle, for a kernel entry."""
    return torch.cuda.current_stream().cuda_stream
