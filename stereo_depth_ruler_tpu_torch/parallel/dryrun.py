"""The sharded pipeline on a world of spawned processes, and the launcher
that starts such a world.

``spawn_world(fn, n, *args)`` runs ``fn(*args)`` on every rank of a new
world of ``n`` spawned processes (file rendezvous in a temporary
directory, so that several worlds may run at once) and returns each
rank's result. ``dryrun_multichip(n)`` is the port of the JAX package's
``__graft_entry__.dryrun_multichip``: the full sharded step (frames x
tiles with halo exchange x the D split, rectification, the right matcher
and WLS, reprojection) on an n-rank mesh, plus the tile route on a
tile-only mesh. ``fn`` is pickled by its import path: it lives in a
module that imports no JAX.

Both take ``device_type``: ``"cuda"`` (the default) is an NCCL world, one
rank per card (rank r on card r), and raises where the machine has fewer
cards than ranks; ``"cpu"`` is a gloo world of CPU processes.

    python -m stereo_depth_ruler_tpu_torch.parallel.dryrun [N] [cuda|cpu]
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["spawn_world", "dryrun_multichip"]


def _rank_main(rank: int, n: int, workdir: str, device_type: str, fn,
               args) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{workdir}/init",
                            world_size=n, rank=rank)
    out = Path(workdir) / f"rank{rank}.pkl"
    try:
        result = ("ok", fn(*args))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    out.write_bytes(pickle.dumps(result))
    dist.destroy_process_group()


def spawn_world(fn, n_processes: int, *args, timeout: float = 300.0,
                device_type: str = "cuda"):
    """``fn(*args)`` on each rank of a new world of ``n_processes`` spawned
    processes, NCCL on one card each (``device_type="cuda"``) or gloo on
    the CPU (``"cpu"``); returns the ranks' results in rank order. Raises
    RuntimeError with the traceback when a rank fails or there are fewer
    cards than ranks, TimeoutError when the world has not finished within
    ``timeout`` seconds; either way every process is stopped before it
    returns."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() < n_processes:
        raise RuntimeError(f"{n_processes} ranks need {n_processes} CUDA "
                           f"cards, found {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_processes, workdir, device_type, fn,
                                   args))
                 for r in range(n_processes)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {n_processes}-process world "
                                       f"ran past {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
        results = []
        for r, p in enumerate(procs):
            f = Path(workdir) / f"rank{r}.pkl"
            status, value = (pickle.loads(f.read_bytes()) if f.exists()
                             else ("error", f"exit code {p.exitcode}"))
            if status != "ok" or p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {n_processes} failed:\n"
                                   f"{value}")
            results.append(value)
    return results


def _factor(n: int):
    """(frame, tile, disp) of an n-rank mesh, all three axes where n
    allows (the JAX package's factoring)."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 2, 1)
    return (n, 1, 1)


def _dryrun_rank(device_type: str, tile_rows: int, width: int,
                 num_disp: int, frames_per_group: int) -> str:
    from ..calib.config import StereoRig
    from ..ops.remap import build_remap_grids
    from ..ops.sgbm_ref import SGBMParams
    from .mesh import make_mesh
    from .sharded import pipeline_step_sharded, sgbm_sharded

    f, t, d = _factor(dist.get_world_size())
    mesh = make_mesh(frame=f, tile=t, disp=d, device_type=device_type)
    H, W, D = tile_rows * t, width, num_disp
    params = SGBMParams(num_disparities=D, block_size=3, p1=72, p2=288,
                        speckle_window_size=0)
    rig = StereoRig.synthetic(width=W, height=H, focal=50.0,
                              baseline_mm=30.0)
    rects = build_remap_grids(rig, torch.device(
        "cuda", torch.cuda.current_device()) if device_type == "cuda"
        else "cpu")
    rng = np.random.default_rng(0)
    lefts = rng.uniform(0, 255, (frames_per_group * f, H, W)).astype(
        np.float32)
    rights = np.roll(lefts, -4, axis=2)
    out = pipeline_step_sharded(lefts, rights, rig.Q, params, mesh, halo=8,
                                rects=rects, use_wls=True)
    disp, xyz = out["disparity"], out["xyz"]
    if tuple(disp.shape) != (frames_per_group, H, W) or \
            tuple(xyz.shape) != (frames_per_group, H, W, 3):
        raise AssertionError(f"shapes {tuple(disp.shape)} "
                             f"{tuple(xyz.shape)}")
    if not bool(torch.isfinite(disp).all()):
        raise AssertionError("non-finite disparity")
    note = ""
    # the tile route on a tile-only mesh (the kernels' plain versions on
    # CPU tensors); every rank builds the mesh, its members match
    tmesh = make_mesh(tile=t, device_type=device_type)
    if t > 1 and tmesh.get_coordinate() is not None:
        Hp, Wp = 16 * t, min(W, 128)
        pparams = SGBMParams(num_disparities=16, block_size=3, p1=72,
                             p2=288, speckle_window_size=0)
        dp = sgbm_sharded(lefts[0, :Hp, :Wp], rights[0, :Hp, :Wp], pparams,
                          tmesh, halo=8, kernel="cuda")
        if tuple(dp.shape) != (Hp, Wp) or not bool(torch.isfinite(dp).all()):
            raise AssertionError(f"tile route: {tuple(dp.shape)}")
        note = f", tile route on a {t}-member tile mesh ok"
    return (f"dryrun_multichip ok: mesh(frame={f}, tile={t}, disp={d}) "
            f"on {device_type}, "
            f"rectify+SGBMx2+WLS+reproject, disp shape per frame group "
            f"{tuple(disp.shape)}, valid frac "
            f"{float((disp >= 0).float().mean()):.2f}{note}")


def dryrun_multichip(n_processes: int, tile_rows: int = 128,
                     width: int = 320, num_disp: int = 64,
                     frames_per_group: int = 4, timeout: float = 600.0,
                     device_type: str = "cuda") -> str:
    """The full sharded pipeline step on an ``n_processes``-rank mesh, one
    card a rank (``device_type="cuda"``) or CPU processes (``"cpu"``),
    (frame, tile, disp) = (n/4, 2, 2) where n allows:
    ``frames_per_group`` random frames per frame group of ``tile_rows`` x
    tile rows by ``width``, ``num_disp`` disparities, halo 8, rectified,
    with the right matcher and WLS; then the tile route on a tile-only
    mesh. Raises on a failure; returns rank 0's one-line summary."""
    return spawn_world(_dryrun_rank, n_processes, device_type, tile_rows,
                       width, num_disp, frames_per_group, timeout=timeout,
                       device_type=device_type)[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                           device_type=sys.argv[2] if len(sys.argv) > 2
                           else "cuda"))
