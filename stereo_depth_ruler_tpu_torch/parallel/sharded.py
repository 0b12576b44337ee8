"""Sharded SGBM over a (frame, tile, disp) mesh on ``torch.distributed``.

Port of ``stereo_depth_ruler_tpu/parallel/sharded.py``. Every rank is one
mesh member and runs the same program; where the JAX package's
``shard_map`` gives each device its block of a global array, each rank here
holds the replicated images and computes its own block:

- **frame**: frames are independent, no communication.
- **tile**: the H rows of the (H, W, D) cost volume are split. Horizontal
  paths are row-local. Vertical and diagonal paths carry state across
  tile boundaries, in one of two modes:
    * ``halo`` (default): each tile gets ``halo`` rows of its neighbours'
      cost (send/recv over the tile group) and warm-starts its vertical
      scans from the zero state that many rows early; the P2 cap and the
      min-normalization fade the start state out (JAX package's
      HALO_r04.jsonl at 720x1280x128: halo 64 exact, halo 32 off on ~1e-5
      of the pixels by at most 0.0625 px). A tile at the image edge gets
      zero rows, the exact path start, so edge tiles are exact.
    * ``exact``: the sequential wavefront. Tile k receives tile k-1's final
      carries, scans, and sends its own on; bitwise equal to one device.
- **disp**: the D planes of the cost volume are split; each member builds
  and scans only its D / n_disp planes. The DP step couples the slices
  by an ``all_reduce(MIN)`` of the row minimum (the P2 term) and a
  one-lane exchange with the neighbouring slices (the P1 term, d +- 1);
  an edge slice takes 1e9 there, the no-neighbour value. WTA, uniqueness,
  subpixel and the LR check reduce with ``all_reduce`` MIN and MAX,
  bitwise equal to one device.

The tile route (``kernel="cuda"``) runs each tile through the hand-written
kernels: K1 builds the tile's slab with its halo rows from the replicated
images, ``sgbm_tile_cuda`` (K9: tile_sgm.cu's three sweeps on an int16
S_dh, or K2 and K3 where ``tile_bias`` gives none) matches it. On CPU
tensors the same route runs the kernels' plain versions.

Collectives are issued by every member of a group in the same order: the
DP collectives run on all members of a disp group, which hold the same
tile, at the same scan step; the wavefront's waiting tiles issue none.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import sgbm as plain
from ..ops import sgbm_cuda as sc
from ..ops.remap import remap_bilinear
from ..ops.reproject import reproject_to_3d
from ..ops.sgbm_ref import SGBMParams
from ..ops.wls_cuda import wls_disparity_filter_cuda
from .mesh import DISP_AXIS, FRAME_AXIS, TILE_AXIS

__all__ = ["sgbm_sharded", "pipeline_step_sharded"]

_BIG = 1e9
_MIN, _MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX


@dataclasses.dataclass(frozen=True)
class _Member:
    """This rank's place in a mesh: the axis sizes, its coordinates, the
    groups of its tile and disp axes, the global ranks of the mesh and its
    device."""
    n_frame: int
    n_tile: int
    n_disp: int
    frame: int
    tile: int
    disp: int
    tile_group: dist.ProcessGroup
    disp_group: dist.ProcessGroup
    ranks: torch.Tensor
    device: torch.device

    def peer(self, axis: str, step: int) -> Optional[int]:
        """Global rank of the member ``step`` away along ``axis``, None
        past the mesh's edge."""
        c = [self.frame, self.tile, self.disp]
        i = (FRAME_AXIS, TILE_AXIS, DISP_AXIS).index(axis)
        c[i] += step
        if not 0 <= c[i] < self.ranks.shape[i]:
            return None
        return int(self.ranks[tuple(c)])


def _member(mesh: DeviceMesh) -> _Member:
    if tuple(mesh.mesh_dim_names or ()) != (FRAME_AXIS, TILE_AXIS, DISP_AXIS):
        raise ValueError(f"need a (frame, tile, disp) mesh (make_mesh), got "
                         f"dims {mesh.mesh_dim_names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not a member of the "
                         "mesh")
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    ranks = mesh.mesh.cpu()
    return _Member(*ranks.shape, *coord, mesh.get_group(TILE_AXIS),
                   mesh.get_group(DISP_AXIS), ranks, device)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def _exchange(to_prev: torch.Tensor, to_next: torch.Tensor, m: _Member,
              axis: str) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """Send ``to_prev`` to the member before this one along ``axis`` and
    ``to_next`` to the one after it, in one batch of sends and receives
    (no pair of neighbours can wait on each other); returns what the one
    before sent (shaped as ``to_next``) and what the one after sent
    (shaped as ``to_prev``), None past the mesh's edge."""
    prev, nxt = m.peer(axis, -1), m.peer(axis, +1)
    ops, from_prev, from_next = [], None, None
    if prev is not None:
        from_prev = torch.empty_like(to_next)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prev),
                dist.P2POp(dist.irecv, from_prev, prev)]
    if nxt is not None:
        from_next = torch.empty_like(to_prev)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt),
                dist.P2POp(dist.irecv, from_next, nxt)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


def _gather_rows(x: torch.Tensor, m: _Member) -> torch.Tensor:
    """The tile group's blocks stacked along the first axis, in tile
    order (the group rank is the tile coordinate)."""
    parts = [torch.empty_like(x) for _ in range(m.n_tile)]
    dist.all_gather(parts, x.contiguous(), group=m.tile_group)
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# local building blocks (a tile's row slab, a member's D slice)
# ---------------------------------------------------------------------------


def _local_cost_slab(left: torch.Tensor, right: torch.Tensor,
                     params: SGBMParams, tile_idx: int, h_local: int,
                     disp_idx: int = 0, n_disp: int = 1) -> torch.Tensor:
    """Cost volume rows [tile_idx*h_local, (tile_idx+1)*h_local) of this
    member's D slice, (h_local, W, D / n_disp) float32, from the replicated
    (H, W) images. The Sobel (+-1 row) and the box (+-block//2 rows) need
    context rows, so an extended slab, clamped to the image, is built and
    cropped. With n_disp > 1 only the member's disparity planes are
    built."""
    pad = params.block_size // 2 + 1
    H = left.shape[0]
    start = tile_idx * h_local
    ext_rows = min(h_local + 2 * pad, H)
    ext_start = min(max(start - pad, 0), H - ext_rows)
    lt = plain.sobel_clip(left[ext_start:ext_start + ext_rows],
                          params.pre_filter_cap)
    rt = plain.sobel_clip(right[ext_start:ext_start + ext_rows],
                          params.pre_filter_cap)
    d_local = params.num_disparities // n_disp
    d0 = params.min_disparity + disp_idx * d_local
    C = plain.bt_cost_volume(lt, rt, d_local, d0)
    C = plain.box_filter_volume(C, params.block_size)
    off = start - ext_start
    return C[off:off + h_local]


def _dp_update_dshard(Lprev: torch.Tensor, c: torch.Tensor, P1: float,
                      P2: float, m: _Member) -> torch.Tensor:
    """One SGM step on a D slice: Lprev and c are (..., D_l) local slices.
    The min over the full D axis is an all_reduce(MIN) over the disp group;
    the d +- 1 neighbours across the slice edges come from the neighbouring
    members, and an edge member takes _BIG there. Bitwise equal to the
    unsharded step on the concatenated slices."""
    if m.n_disp == 1:
        return plain._dp_update(Lprev, c, P1, P2)
    minL = _all_reduce(Lprev.amin(dim=-1, keepdim=True), _MIN, m.disp_group)
    from_prev, from_next = _exchange(Lprev[..., :1], Lprev[..., -1:], m,
                                     DISP_AXIS)
    big = torch.full_like(Lprev[..., :1], _BIG)
    lm1 = torch.cat([big if from_prev is None else from_prev,
                     Lprev[..., :-1]], dim=-1)
    lp1 = torch.cat([Lprev[..., 1:],
                     big if from_next is None else from_next], dim=-1)
    best = torch.minimum(torch.minimum(Lprev, minL + P2),
                         torch.minimum(lm1, lp1) + P1)
    return c + best - minL


def _wta_dshard(S: torch.Tensor, params: SGBMParams, m: _Member
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WTA, uniqueness and subpixel on a D-sliced (H, W, D_l) volume, by
    all-reduces over the disp group: s0 and the winner (ties to the
    smallest global d, as argmin) by MIN, the uniqueness violation by MAX,
    the subpixel neighbours S[d* +- 1] by MIN of masked values. Returns
    (disp, valid), equal on every member and bitwise equal to
    ``plain.wta``."""
    if m.n_disp == 1:
        return plain.wta(S, params)
    H, W, Dl = S.shape
    D = Dl * m.n_disp
    g = m.disp_group
    dg = torch.arange(Dl, device=S.device) + m.disp * Dl       # global d
    s0 = _all_reduce(S.amin(dim=-1), _MIN, g)
    d_star = _all_reduce(torch.where(S == s0[..., None], dg, D).amin(dim=-1),
                         _MIN, g)
    valid = torch.ones((H, W), dtype=torch.bool, device=S.device)
    if params.uniqueness_ratio > 0:
        thresh = s0 * ((100 + params.uniqueness_ratio) / 100.0)
        far = (dg - d_star[..., None]).abs() > 1
        bad = torch.where(far & (S < thresh[..., None]), 1.0, 0.0)
        valid &= _all_reduce(bad.amax(dim=-1), _MAX, g) < 0.5
    # the unsharded wta clips d* +- 1 into [0, D-1]; the clipped value
    # only matters where the offset is zeroed at the ends
    dm = torch.clamp(d_star - 1, 0, D - 1)[..., None]
    dp = torch.clamp(d_star + 1, 0, D - 1)[..., None]
    sm = _all_reduce(torch.where(dg == dm, S, _BIG).amin(dim=-1), _MIN, g)
    sp = _all_reduce(torch.where(dg == dp, S, _BIG).amin(dim=-1), _MIN, g)
    denom = torch.clamp(sm + sp - 2.0 * s0, min=1e-6)
    offset = torch.clamp((sm - sp) / (2.0 * denom), -0.5, 0.5)
    offset = torch.where((d_star == 0) | (d_star == D - 1),
                         torch.zeros_like(offset), offset)
    disp = (d_star.to(torch.float32) + offset) + params.min_disparity
    if params.quantize_16:
        disp = torch.round(disp * 16.0) / 16.0
    xs = torch.arange(W, device=S.device)
    valid &= (d_star + params.min_disparity) <= xs
    return disp.to(torch.float32), valid


def _lr_check_dshard(S: torch.Tensor, disp: torch.Tensor,
                     valid: torch.Tensor, params: SGBMParams, m: _Member
                     ) -> torch.Tensor:
    """The LR check on the D-sliced volume: the per-column winner (s0, d*)
    by two MIN all-reduces over the disp group, after which the winner
    scatter is local and the same on every member."""
    if params.disp12_max_diff < 0:
        return valid
    if m.n_disp == 1:
        return plain.lr_check(S, disp, valid, params)
    H, W, Dl = S.shape
    D = Dl * m.n_disp
    g = m.disp_group
    dg = torch.arange(Dl, device=S.device) + m.disp * Dl
    s0 = _all_reduce(S.amin(dim=-1), _MIN, g)
    d_star = _all_reduce(torch.where(S == s0[..., None], dg, D).amin(dim=-1),
                         _MIN, g)
    disp2 = plain._winner_scatter_disp2(s0.to(torch.int32),
                                        d_star.to(torch.int32), D,
                                        params.min_disparity)
    xs = torch.arange(W, device=S.device, dtype=torch.int32)
    xr = xs - torch.round(disp).to(torch.int32)
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = torch.gather(disp2, -1, torch.clamp(xr, 0, W - 1).to(torch.int64))
    consistent = (d2 >= 0) & ((d2 - disp).abs() <= params.disp12_max_diff)
    return valid & torch.where(xr_ok, consistent, torch.ones_like(xr_ok))


def _shift_w(x: torch.Tensor, direction: int) -> torch.Tensor:
    """Shift a (W, D) carry along W; the vacated column takes the zero
    state (a path entering from the image border)."""
    z = torch.zeros_like(x[:1])
    if direction > 0:
        return torch.cat([z, x[:-1]], dim=0)
    return torch.cat([x[1:], z], dim=0)


def _scan_h(cost: torch.Tensor, P1: float, P2: float, reverse: bool,
            update=None) -> torch.Tensor:
    """Horizontal path (row-local): a scan over W with an (h, D_l)
    carry."""
    update = update or plain._dp_update
    W = cost.shape[1]
    carry = torch.zeros((cost.shape[0], cost.shape[2]), dtype=cost.dtype,
                        device=cost.device)
    out = [None] * W
    for x in (range(W - 1, -1, -1) if reverse else range(W)):
        carry = update(carry, cost[:, x], P1, P2)
        out[x] = carry
    return torch.stack(out, dim=1)


def _v_step(carry, c, P1, P2, with_diag: bool, update):
    """One row of the vertical scan (with its two diagonals): the new
    carry and the row's summed path values. The diagonals' shift along W
    is the same relative to the scan order going down and up."""
    if with_diag:
        pv, pdr, pdl = carry
        Lv = update(pv, c, P1, P2)
        Ldr = update(_shift_w(pdr, +1), c, P1, P2)
        Ldl = update(_shift_w(pdl, -1), c, P1, P2)
        return (Lv, Ldr, Ldl), Lv + Ldr + Ldl
    Lv = update(carry, c, P1, P2)
    return Lv, Lv


def _scan_rows(cost: torch.Tensor, carry, P1, P2, reverse: bool,
               with_diag: bool, update):
    """The vertical scan over the rows of ``cost`` from ``carry``: (final
    carry, (rows, W, D_l) summed path values)."""
    out = [None] * cost.shape[0]
    for y in (range(cost.shape[0] - 1, -1, -1) if reverse
              else range(cost.shape[0])):
        carry, out[y] = _v_step(carry, cost[y], P1, P2, with_diag, update)
    return carry, torch.stack(out, dim=0)


def _zero_carry(cost: torch.Tensor, with_diag: bool):
    z = torch.zeros(cost.shape[1:], dtype=cost.dtype, device=cost.device)
    return (z, z, z) if with_diag else z


def _scan_v(cost_ext: torch.Tensor, P1: float, P2: float, reverse: bool,
            keep: int, with_diag: bool, update=None) -> torch.Tensor:
    """Vertical (+ diagonal) pass over an extended slab from the zero
    state; returns the last (``reverse=False``) or the first
    (``reverse=True``) ``keep`` rows of the summed path volumes."""
    update = update or plain._dp_update
    _, S = _scan_rows(cost_ext, _zero_carry(cost_ext, with_diag), P1, P2,
                      reverse, with_diag, update)
    return S[:keep] if reverse else S[S.shape[0] - keep:]


def _aggregate_tile_halo(cost: torch.Tensor, params: SGBMParams,
                         halo: int, num_paths: int, m: _Member
                         ) -> torch.Tensor:
    """Tile- and disp-sharded aggregation, halo mode: the path sum of this
    member's (h_local, W, D_l) slab. The neighbours' ``halo`` rows come by
    send/recv over the tile group; a tile at the image edge takes zero
    rows, the exact path start."""
    P1, P2 = float(params.P1), float(params.P2)
    h_local = cost.shape[0]
    halo = min(halo, h_local)
    with_diag = num_paths == 8
    upd = partial(_dp_update_dshard, m=m)
    S = (_scan_h(cost, P1, P2, reverse=False, update=upd)
         + _scan_h(cost, P1, P2, reverse=True, update=upd))
    if num_paths == 2:
        return S
    down_ext, up_ext = cost, cost
    if m.n_tile > 1:
        prev_slab, next_slab = _exchange(cost[:halo], cost[h_local - halo:],
                                         m, TILE_AXIS)
        zero = torch.zeros_like(cost[:halo])
        down_ext = torch.cat([zero if prev_slab is None else prev_slab, cost])
        up_ext = torch.cat([cost, zero if next_slab is None else next_slab])
    S = S + _scan_v(down_ext, P1, P2, reverse=False, keep=h_local,
                    with_diag=with_diag, update=upd)
    S = S + _scan_v(up_ext, P1, P2, reverse=True, keep=h_local,
                    with_diag=with_diag, update=upd)
    return S


def _send_carry(carry, dst: int) -> None:
    dist.send(torch.stack(carry) if isinstance(carry, tuple) else carry, dst)


def _recv_carry(like, src: int):
    if isinstance(like, tuple):
        buf = torch.empty((len(like),) + like[0].shape, dtype=like[0].dtype,
                          device=like[0].device)
        dist.recv(buf, src)
        return tuple(buf.unbind(0))
    buf = torch.empty_like(like)
    dist.recv(buf, src)
    return buf


def _aggregate_tile_exact(cost: torch.Tensor, params: SGBMParams,
                          num_paths: int, m: _Member) -> torch.Tensor:
    """Exact sequential-wavefront aggregation: tile k's vertical scan
    starts from the final carries of tile k-1 (down) or k+1 (up), received
    over the tile axis, and sends its own on; bitwise equal to the
    single-device scan. Composes with the D split: the members of a disp
    group hold one tile and run each scan, and its collectives, together;
    a waiting tile issues none."""
    P1, P2 = float(params.P1), float(params.P2)
    with_diag = num_paths == 8
    upd = partial(_dp_update_dshard, m=m)
    S = (_scan_h(cost, P1, P2, reverse=False, update=upd)
         + _scan_h(cost, P1, P2, reverse=True, update=upd))
    if num_paths == 2:
        return S
    for reverse, step in ((False, -1), (True, +1)):
        src, dst = m.peer(TILE_AXIS, step), m.peer(TILE_AXIS, -step)
        carry = _zero_carry(cost, with_diag)
        if src is not None:
            carry = _recv_carry(carry, src)
        carry, Sv = _scan_rows(cost, carry, P1, P2, reverse, with_diag, upd)
        if dst is not None:
            _send_carry(carry, dst)
        S = S + Sv
    return S


# ---------------------------------------------------------------------------
# the tile route on the hand-written kernels
# ---------------------------------------------------------------------------


def _tile_halo(n_tile: int, h_local: int, halo: int) -> int:
    """The halo the tile route runs: none with one tile; else ``halo``
    rounded up so that h_local + halo is a multiple of 8, as the JAX
    package rounds it for its kernel's row blocks. The halo's length is
    the scans' warm-up and so part of the result: the rounding stays."""
    return 0 if n_tile == 1 else halo + (-(h_local + halo)) % 8


def _tile_slab(left: torch.Tensor, right: torch.Tensor, params: SGBMParams,
               tile_idx: int, n_tile: int, h_local: int, halo: int
               ) -> Tuple[torch.Tensor, int]:
    """(C, halo): tile ``tile_idx``'s (1, h_local + 2 * halo, W, D) int16
    cost slab, built by K1 from the replicated (H, W) images, and the halo
    it was built with. Its rows outside the image take zero cost, the
    exact path start (edge tiles are exact), so no rows are exchanged."""
    H, W = left.shape
    halo = _tile_halo(n_tile, h_local, halo)
    pad = params.block_size // 2 + 1            # the box's rows + Sobel's
    M = h_local + 2 * halo                      # the slab's rows
    start = tile_idx * h_local
    # Sobel first, then the clamped row gather: the matcher replicates the
    # border Sobel rows; a Sobel of gathered image rows would differ there
    g = torch.arange(M + 2 * pad, device=left.device) + (start - halo - pad)
    gi = g.clamp(0, H - 1)
    cap = params.pre_filter_cap
    lt = plain.sobel_clip(left, cap)[gi][None].contiguous()
    rt = plain.sobel_clip(right, cap)[gi][None].contiguous()
    C = sc.cost_volume(lt, rt, params)[:, pad:pad + M]
    C[:, :max(0, halo - start)] = 0
    C[:, M - max(0, start - halo + M - H):] = 0
    return C, halo


def _sgbm_cuda_tile(left: torch.Tensor, right: torch.Tensor,
                    params: SGBMParams, tile_idx: int, n_tile: int,
                    h_local: int, halo: int, apply_lr: bool = True
                    ) -> torch.Tensor:
    """Halo-mode tile matcher on the kernels: this tile's (h_local, W)
    disparity rows, -1.0 where invalid; ``_tile_slab``'s slab matched by
    ``sgbm_tile_cuda`` (K9)."""
    C, halo = _tile_slab(left, right, params, tile_idx, n_tile, h_local,
                         halo)
    return sc.sgbm_tile_cuda(C, params, halo, halo, apply_lr)[0]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _resolve_kernel(kernel: str, n_disp: int, exact: bool,
                    params: SGBMParams, device_type: str) -> str:
    """'auto' -> the kernels (``"cuda"``) on a CUDA mesh when the
    configuration allows (halo mode, an unsplit D axis, >= 4 paths); the
    plain scans (``"torch"``) otherwise. The D split and the exact
    wavefront couple the members at every DP row step, which a kernel that
    owns its carry for the whole slab cannot do without one launch per
    row; tiles alone split the volume's memory the same way and run the
    kernels. ``"cuda"`` with a D split or exact raises ValueError; on CPU
    tensors it runs the kernels' plain versions."""
    if kernel == "auto":
        ok = (device_type == "cuda" and n_disp == 1 and not exact
              and params.num_paths >= 4)
        return "cuda" if ok else "torch"
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"kernel must be 'auto', 'cuda' or 'torch', got "
                         f"{kernel!r}")
    if kernel == "cuda" and (n_disp != 1 or exact):
        raise ValueError("the kernels run halo mode with an unsplit D axis "
                         "(exact and the D split run the plain scans)")
    return kernel


def _image(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=device, dtype=torch.float32)


def _match(left: torch.Tensor, right: torch.Tensor, params: SGBMParams,
           m: _Member, h_local: int, halo: int, exact: bool,
           kernel: str) -> torch.Tensor:
    """This member's (h_local, W) disparity rows, -1.0 where invalid."""
    if kernel == "cuda":
        return _sgbm_cuda_tile(left, right, params, m.tile, m.n_tile,
                               h_local, halo,
                               apply_lr=params.disp12_max_diff >= 0)
    C = _local_cost_slab(left, right, params, m.tile, h_local, m.disp,
                         m.n_disp)
    if exact:
        S = _aggregate_tile_exact(C, params, params.num_paths, m)
    else:
        S = _aggregate_tile_halo(C, params, halo, params.num_paths, m)
    disp, valid = _wta_dshard(S, params, m)
    valid = _lr_check_dshard(S, disp, valid, params, m)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def sgbm_sharded(left, right, params: SGBMParams, mesh: DeviceMesh,
                 halo: int = 32, exact: bool = False,
                 apply_speckle: bool = True, kernel: str = "auto"
                 ) -> torch.Tensor:
    """One pair's SGBM split over the mesh's (tile, disp) axes; every
    member calls it with the same (H, W) images.

    The images are replicated; the cost volume and the DP state are split,
    rows over tile and disparity planes over disp (each member holds an
    (H / n_tile, W, D / n_disp) block). ``exact`` wavefront mode composes
    with the D split and is bitwise equal to one device. ``kernel``:
    ``"auto"``, ``"cuda"`` (the tile route on the kernels) or ``"torch"``
    (the plain scans); the route is the matcher's only, the speckle filter
    on the gathered map is K4 and K5 on any CUDA mesh. Returns the full
    (H, W) float32 disparity, -1.0 where invalid, on every member, on its
    device."""
    m = _member(mesh)
    left, right = _image(left, m.device), _image(right, m.device)
    H, W = left.shape
    if H % m.n_tile:
        raise ValueError(f"H={H} must divide into {m.n_tile} tiles")
    if params.num_disparities % m.n_disp:
        raise ValueError(f"num_disparities={params.num_disparities} must "
                         f"divide into {m.n_disp} slices")
    kernel = _resolve_kernel(kernel, m.n_disp, exact, params, m.device.type)
    disp = _gather_rows(_match(left, right, params, m, H // m.n_tile, halo,
                               exact, kernel), m)
    if apply_speckle:
        disp = sc.remove_speckles(disp[None], params)[0]
    return disp


def pipeline_step_sharded(lefts, rights, rig_Q, params: SGBMParams,
                          mesh: DeviceMesh, halo: int = 32,
                          scale: float = 1.0, kernel: str = "auto",
                          use_wls: bool = False, rects=None,
                          apply_speckle: bool = False):
    """Batched frames over the full (frame, tile, disp) mesh: rectify ->
    SGBM (twice with WLS) -> post-filter -> reproject, per frame.

    Every member calls it with the same (N, H, W) batch. The frames split
    over the frame axis: frame-group f takes frames [f * N / n_frame,
    (f + 1) * N / n_frame), and each of them is matched tile- and
    disp-split as ``sgbm_sharded`` does. ``rects`` ((RemapGrid, RemapGrid)
    on the mesh's device) rectifies the eyes first; ``use_wls`` adds the
    right matcher (the left matcher on the mirrored, swapped eyes, split
    the same way: W is not split, so the flip is local) and the WLS filter
    (K6 and K7); the WLS and speckle (K4 and K5) filters run on the
    gathered full map, the same on every member of a frame group, on any
    route (their plain versions on CPU tensors); each tile reprojects its own rows (global row
    offsets) and the tile group gathers them.

    Returns {"disparity": (N / n_frame, H, W), "xyz": (N / n_frame, H, W,
    3)}: each member returns its own frame group's frames, the counterpart
    of the JAX package's arrays sharded over the frame axis."""
    m = _member(mesh)
    lefts, rights = _image(lefts, m.device), _image(rights, m.device)
    N, H, W = lefts.shape
    if N % m.n_frame or H % m.n_tile:
        raise ValueError(f"{N} frames of {H} rows must divide into "
                         f"{m.n_frame} frame groups and {m.n_tile} tiles")
    h_local = H // m.n_tile
    kernel = _resolve_kernel(kernel, m.n_disp, False, params, m.device.type)
    Q = np.asarray(rig_Q, np.float64)
    per = N // m.n_frame
    rows = slice(m.tile * h_local, (m.tile + 1) * h_local)

    def match(l, r):
        return _gather_rows(_match(l, r, params, m, h_local, halo, False,
                                   kernel), m)

    disps, xyzs = [], []
    for i in range(m.frame * per, (m.frame + 1) * per):
        left, right = lefts[i], rights[i]
        if rects is not None:
            left = remap_bilinear(left, rects[0])
            right = remap_bilinear(right, rects[1])
        disp = match(left, right)
        if use_wls:
            disp_r = match(right.flip(-1), left.flip(-1)).flip(-1)
            filtered, _ = wls_disparity_filter_cuda(
                disp[None], disp_r[None].contiguous(), left[None],
                max_disp=params.num_disparities + params.min_disparity)
            disp = filtered[0]
        if apply_speckle:
            disp = sc.remove_speckles(disp[None], params)[0]
        xyz = reproject_to_3d(disp[rows], Q, scale=scale,
                              row_offset=m.tile * h_local)
        disps.append(disp)
        xyzs.append(_gather_rows(xyz, m))
    return {"disparity": torch.stack(disps), "xyz": torch.stack(xyzs)}
