"""The sort family of the speckle filter on two hand-written CUDA kernels
(``ops/csrc``).

Counterpart of ``stereo_depth_ruler_tpu/ops/sort_tpu.py``:

- ``radix_sort.cu``: a stable LSD radix sort of int32 keys, key-only
  (``sort_keys``) or with int32 values (``sort_pairs``), one sort per frame
  of a batch. It replaces the TPU's bitonic sorts: the key-only
  ``_bitonic_sort_single``, the pair ``_bitonic_sort_staged`` and the
  one-launch ``_bitonic_sort_fused``;
- ``sorted_runs.cu``: scans over sorted keys. ``run_sizes`` (the TPU sizes
  scan) and ``run_keep`` (its keep scan) find each position's run and
  write the size, or size > max_size, back through the sorted positions'
  source indices, which replaces the TPU's unpermute sorts;
  ``large_run_roots`` (the TPU roots kernel) lists, per row of L sorted
  positions, the values of the runs longer than max_size.

``sorted_labels``, ``equal_value_counts`` and ``speckle_keep_sorted`` (the
TPU's ``speckle_keep_pallas``) compose them as ``ops/sort.py`` defines.

Each wrapper dispatches on the device of its input: a CPU tensor gets the
plain version of ``ops/sort.py``; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per kernel and mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import kernels
from . import sort as plain
from .sort import pack_batched

__all__ = ["LAUNCHES", "reset_launch_counts", "pack_batched", "sort_keys",
           "sort_pairs", "run_sizes", "run_keep", "large_run_roots",
           "sorted_labels", "equal_value_counts", "speckle_keep_sorted"]

LAUNCHES = {"radix_sort_keys": 0, "radix_sort_pairs": 0,
            "sorted_runs_sizes": 0, "sorted_runs_keep": 0,
            "sorted_runs_roots": 0}

# sorted_runs.cu's modes
_SIZES, _KEEP, _ROOTS = 0, 1, 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _frames(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(B, N) of a contiguous int32 batch of frames."""
    if t.dtype != torch.int32 or t.dim() < 2 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous int32 tensor with a "
                         f"batch axis, got {t.dtype} {tuple(t.shape)}")
    return t.shape[0], t[0].numel()


def _radix_sort(key: torch.Tensor, val: Optional[torch.Tensor]):
    B, N = _frames(key, "key")
    lib = kernels.load()
    skey, tkey = torch.empty_like(key), torch.empty_like(key)
    sval = tval = None
    if val is not None:
        if val.shape != key.shape:
            raise ValueError(f"shape mismatch {tuple(key.shape)} "
                             f"{tuple(val.shape)}")
        _frames(val, "val")
        sval, tval = torch.empty_like(val), torch.empty_like(val)
    n_scratch = lib.sdr_radix_scratch_size(B, N)
    if n_scratch < 0:
        raise ValueError(f"radix sort: no sort of {B} x {N} keys")
    # digit histograms, pass flags, tile counters and look-back status
    scratch = torch.zeros(n_scratch, dtype=torch.int32, device=key.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.sdr_radix_sort(key.data_ptr(), ptr(val), skey.data_ptr(),
                            ptr(sval), tkey.data_ptr(), ptr(tval),
                            scratch.data_ptr(), B, N, kernels.stream())
    name = "radix_sort_keys" if val is None else "radix_sort_pairs"
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return skey, sval


def sort_keys(key: torch.Tensor) -> torch.Tensor:
    """Each frame of (B, ...) int32 keys in [0, 2**31) sorted ascending
    over its flat order, in the input's shape."""
    if not kernels.on_cuda(key):
        return plain.sort_keys(key)
    return _radix_sort(key, None)[0]


def sort_pairs(key: torch.Tensor, val: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, val) int32 pairs of each frame sorted by key, stably (equal
    keys keep their values in input order)."""
    if not kernels.on_cuda(key, val):
        return plain.sort_pairs(key, val)
    return _radix_sort(key, val)


def _sorted_runs(skey: torch.Tensor, sidx: Optional[torch.Tensor],
                 out: torch.Tensor, mode: int, max_size: int = 0,
                 L: int = 1, slots: int = 0) -> torch.Tensor:
    B, N = _frames(skey, "skey")
    n_out = out[0].numel()
    if sidx is not None:
        _frames(sidx, "sidx")
        if sidx.shape != skey.shape:
            raise ValueError(f"shape mismatch {tuple(skey.shape)} "
                             f"{tuple(sidx.shape)}")
    rc = kernels.load().sdr_sorted_runs(
        skey.data_ptr(), None if sidx is None else sidx.data_ptr(),
        out.data_ptr(), B, N, n_out, mode, int(max_size), L, slots,
        kernels.stream())
    name = ("sorted_runs_sizes", "sorted_runs_keep",
            "sorted_runs_roots")[mode]
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def run_sizes(skey: torch.Tensor, sidx: torch.Tensor = None,
              n: int = 0) -> torch.Tensor:
    """``plain.run_sizes``: the run length at each sorted position, (B, N)
    int32, or with ``sidx`` written back through it into (B, n)."""
    if not kernels.on_cuda(skey, *([] if sidx is None else [sidx])):
        return plain.run_sizes(skey, sidx, n)
    B, N = _frames(skey, "skey")
    out = torch.empty((B, N if sidx is None else n), dtype=torch.int32,
                      device=skey.device)
    return _sorted_runs(skey, sidx, out, _SIZES)


def run_keep(skey: torch.Tensor, sidx: torch.Tensor, n: int,
             max_size: int) -> torch.Tensor:
    """``plain.run_keep``: (B, n) bool, run length > max_size, written back
    through ``sidx``."""
    if not kernels.on_cuda(skey, sidx):
        return plain.run_keep(skey, sidx, n, max_size)
    out = torch.empty((skey.shape[0], n), dtype=torch.bool,
                      device=skey.device)
    return _sorted_runs(skey, sidx, out, _KEEP, max_size)


def large_run_roots(skey: torch.Tensor, n2: int, L: int,
                    max_size: int) -> torch.Tensor:
    """``plain.large_run_roots``: (B, R, L) sorted blocks -> (B, R, slots)
    int32 values of the runs longer than max_size that start in each row,
    descending, then -1."""
    if not kernels.on_cuda(skey):
        return plain.large_run_roots(skey, n2, L, max_size)
    B, N = _frames(skey, "skey")
    if N != n2 or n2 % L:
        raise ValueError(f"need (B, R, L) blocks of n2 = {n2} with L = {L}, "
                         f"got {tuple(skey.shape)}")
    slots = plain.roots_slots(L, max_size)
    out = torch.empty((B, n2 // L, slots), dtype=torch.int32,
                      device=skey.device)
    return _sorted_runs(skey, None, out, _ROOTS, max_size, L, slots)


def sorted_labels(labels: torch.Tensor):
    """(B, ...) labels -> (the (B, R, L) key-sorted blocks, n, n2, L, R),
    on the key-only sort."""
    return plain.sorted_labels(labels, sort=sort_keys)


def equal_value_counts(labels: torch.Tensor) -> torch.Tensor:
    """(B, ...) int labels -> per element, the count of equal values in its
    frame: the pair sort, then the sizes scan through the positions."""
    return plain.equal_value_counts(labels, pairs=sort_pairs, sizes=run_sizes)


def speckle_keep_sorted(labels: torch.Tensor, max_size: int) -> torch.Tensor:
    """(B, ...) labels -> bool, count of equal labels > max_size, for every
    element (the TPU's ``speckle_keep_pallas``): the pair sort, then the
    keep scan through the positions."""
    return plain.speckle_keep_sorted(labels, max_size, pairs=sort_pairs,
                                     keep=run_keep)
