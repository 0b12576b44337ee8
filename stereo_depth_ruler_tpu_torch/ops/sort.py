"""Sorts and scans over sorted labels in plain PyTorch — the plain versions
of the sort kernels (csrc/radix_sort.cu, csrc/sorted_runs.cu).

Counterpart of ``stereo_depth_ruler_tpu/ops/sort_tpu.py``: the same
packing (``pack_batched``: each frame's labels flattened and padded with
``INF = 2**30`` to n2, the next power of two, viewed as (R, L) with
L = min(n2, 1024)) and the same outputs. Every function takes a batch of
frames on the leading axis. The TPU module builds them from bitonic
networks; here the sorts are ``torch.sort(stable=True)`` and the scans are
cumulative max/min over run starts, as the TPU scans compute them.

Keys must lie in [0, 2**30), as the TPU packing assumes. ``sort_pairs`` is
stable: equal keys keep their values in input order, where the TPU's
bitonic network leaves them in an order of its own (every output built on
the sort below is independent of that order).

``ops/sort_cuda.py`` holds the kernel wrappers; its CPU path is this
module.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["INF", "pack_batched", "positions", "sort_keys", "sort_pairs",
           "run_sizes", "run_keep", "large_run_roots", "roots_slots",
           "sorted_labels", "equal_value_counts", "speckle_keep_sorted"]

INF = 2 ** 30   # the pad value of pack_batched


def pack_batched(labels: torch.Tensor):
    """(B, ...) int labels -> ((B, R, L) int32 blocks, n, n2, L, R): each
    frame's n elements flattened and padded with INF to n2, the next power
    of two, in rows of L = min(n2, 1024)."""
    B = labels.shape[0]
    n = labels[0].numel()
    n2 = 1
    while n2 < n:
        n2 *= 2
    L = min(n2, 1024)
    key = torch.full((B, n2), INF, dtype=torch.int32, device=labels.device)
    key[:, :n] = labels.reshape(B, n)
    return key.reshape(B, n2 // L, L), n, n2, L, n2 // L


def positions(key: torch.Tensor) -> torch.Tensor:
    """Each element's flat index in its frame, in the shape of the (B, ...)
    ``key``: the values whose pair sort gives the source indices."""
    B = key.shape[0]
    return torch.arange(key[0].numel(), dtype=torch.int32,
                        device=key.device).expand(B, -1).reshape(
                            key.shape).contiguous()


def sort_keys(key: torch.Tensor) -> torch.Tensor:
    """Each frame of (B, ...) int32 keys sorted ascending (over the frame's
    flat order), in the input's shape."""
    B = key.shape[0]
    return torch.sort(key.reshape(B, -1), dim=1,
                      stable=True).values.reshape(key.shape)


def sort_pairs(key: torch.Tensor, val: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, val) pairs of each frame sorted by key, stably: equal keys keep
    their values in input order. Shapes as the inputs'."""
    B = key.shape[0]
    skey, idx = torch.sort(key.reshape(B, -1), dim=1, stable=True)
    sval = torch.gather(val.reshape(B, -1), 1, idx)
    return skey.reshape(key.shape), sval.reshape(val.shape)


def _run_starts(skey: torch.Tensor) -> torch.Tensor:
    """(B, N) sorted keys -> True where a run of equal keys starts. The
    element before position 0 reads as INF - 1, as in the TPU scans."""
    prev = torch.cat([torch.full_like(skey[:, :1], INF - 1), skey[:, :-1]],
                     dim=1)
    return skey != prev


def _sizes_sorted(skey: torch.Tensor) -> torch.Tensor:
    """(B, N) sorted keys -> the length of the run at each position: the
    next run start minus the last run start, each a cumulative scan (the
    TPU kernel's max and min doubling scans)."""
    N = skey.shape[1]
    f = torch.arange(N, dtype=torch.int32,
                     device=skey.device).expand_as(skey)
    start = _run_starts(skey)
    rs = torch.cummax(torch.where(start, f, torch.zeros_like(f)), 1).values
    ne = torch.where(start, f, torch.full_like(f, N))
    ne = torch.cat([ne[:, 1:], torch.full_like(ne[:, :1], N)], dim=1)
    nxt = torch.cummin(ne.flip(1), 1).values.flip(1)
    return nxt - rs


def _through(sorted_vals: torch.Tensor, sidx: torch.Tensor, n: int
             ) -> torch.Tensor:
    """out[b, sidx[b, i]] = sorted_vals[b, i] for the targets below n ->
    (B, n): the unpermute of the sorted order."""
    B = sorted_vals.shape[0]
    out = torch.empty((B, n + 1), dtype=sorted_vals.dtype,
                      device=sorted_vals.device)
    tgt = torch.clamp(sidx.reshape(B, -1).to(torch.int64), max=n)
    out.scatter_(1, tgt, sorted_vals)
    return out[:, :n]


def run_sizes(skey: torch.Tensor, sidx: torch.Tensor = None,
              n: int = 0) -> torch.Tensor:
    """Length of the run of equal keys at each position of each frame's
    sorted keys (the TPU sizes scan's output), (B, N) int32. With ``sidx``
    (the sorted positions' source indices) the sizes go back through it
    into a (B, n) array: out[b, sidx[b, i]] = size, targets >= n
    dropped."""
    B = skey.shape[0]
    sizes = _sizes_sorted(skey.reshape(B, -1))
    return sizes if sidx is None else _through(sizes, sidx, n)


def run_keep(skey: torch.Tensor, sidx: torch.Tensor, n: int,
             max_size: int) -> torch.Tensor:
    """(B, n) bool: run length > max_size, written back through ``sidx``
    as in ``run_sizes`` (the TPU keep scan and its unpermute sort)."""
    B = skey.shape[0]
    keep = _sizes_sorted(skey.reshape(B, -1)) > max_size
    return _through(keep, sidx, n)


def roots_slots(L: int, max_size: int) -> int:
    """Roots per row: starts of runs longer than max_size lie more than
    max_size apart, so a row of L positions holds at most this many."""
    return -(-L // (max_size + 1))


def large_run_roots(skey: torch.Tensor, n2: int, L: int,
                    max_size: int) -> torch.Tensor:
    """(B, R, L) sorted blocks -> (B, R, slots) int32: per row of L flat
    positions, the values of the runs that start in that row and are
    longer than max_size (skey[f + max_size] == skey[f], past n2 no
    match), in descending order, then -1. INF and a sentinel can be roots;
    the caller filters them."""
    B = skey.shape[0]
    flat = skey.reshape(B, n2)
    start = _run_starts(flat)
    ahead = torch.full_like(flat, -1)
    if max_size < n2:
        ahead[:, :n2 - max_size] = flat[:, max_size:]
    large = start & (ahead == flat)
    v = torch.where(large, flat, torch.full_like(flat, -1)).reshape(B, -1, L)
    slots = roots_slots(L, max_size)
    return torch.sort(v, dim=-1, descending=True).values[..., :slots]


def sorted_labels(labels: torch.Tensor, sort=sort_keys):
    """(B, ...) labels -> (the (B, R, L) key-sorted blocks, n, n2, L, R)."""
    key, n, n2, L, R = pack_batched(labels)
    return sort(key), n, n2, L, R


def equal_value_counts(labels: torch.Tensor, pairs=sort_pairs,
                       sizes=run_sizes) -> torch.Tensor:
    """(B, ...) int labels -> per element, the count of equal values in its
    frame: a (key, position) pair sort, then the run sizes written back
    through the positions. ``pairs`` and ``sizes`` are the sort and the
    scan to use (the kernels' wrappers in ops/sort_cuda.py)."""
    key, n, *_ = pack_batched(labels)
    skey, sidx = pairs(key, positions(key))
    return sizes(skey, sidx, n).reshape(labels.shape)


def speckle_keep_sorted(labels: torch.Tensor, max_size: int,
                        pairs=sort_pairs, keep=run_keep) -> torch.Tensor:
    """(B, ...) labels -> bool, count of equal labels > max_size, for every
    element (the sentinel label included): the TPU's
    ``speckle_keep_pallas``. ``pairs`` and ``keep`` as in
    ``equal_value_counts``."""
    key, n, *_ = pack_batched(labels)
    skey, sidx = pairs(key, positions(key))
    return keep(skey, sidx, n, max_size).reshape(labels.shape)
