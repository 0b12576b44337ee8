"""Device mesh of the stereo engine on ``torch.distributed``.

Port of ``stereo_depth_ruler_tpu/parallel/mesh.py``. The scale-out axes
are the same:

- ``frame``: data parallelism over video frames (the pipeline's batch
  axis); frames are independent;
- ``tile``: the image rows of the cost volume are split over the members
  (SGM's vertical and diagonal paths cross tiles: halo rows or the exact
  wavefront, ``parallel/sharded.py``);
- ``disp``: the disparity range of the cost volume is split over the
  members (the DP step and the WTA reduce across them).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dim names
(frame, tile, disp), frame outermost and disp innermost, over the ranks
0 .. frame*tile*disp - 1 of the default process group. Each rank is one
member: a GPU under NCCL (the rank's current CUDA device), or a CPU
process under gloo. Every rank of the world constructs every mesh, in the
same order, since creating its groups is collective; ranks past the mesh's
size are no members of it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_global_mesh", "initialize_distributed",
           "FRAME_AXIS", "TILE_AXIS", "DISP_AXIS"]

FRAME_AXIS = "frame"
TILE_AXIS = "tile"
DISP_AXIS = "disp"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Start the default process group of a multi-process run.

    With no arguments the values come from SDR_COORDINATOR (``host:port``,
    or an init-method URL such as ``tcp://host:port`` or ``file://path``),
    SDR_NUM_PROCESSES and SDR_PROCESS_ID. The backend is NCCL where CUDA
    is available, the process taking the CUDA device process_id modulo the
    device count; gloo otherwise. Returns True when it started a process
    group, False in the single-process case (nothing set) and where one is
    running already, so that it is safe to call unconditionally."""
    coordinator_address = coordinator_address or os.environ.get(
        "SDR_COORDINATOR")
    if num_processes is None and "SDR_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SDR_NUM_PROCESSES"])
    if process_id is None and "SDR_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SDR_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(SDR_COORDINATOR, SDR_NUM_PROCESSES, SDR_PROCESS_ID)")
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def _check_device_type(device_type: str) -> None:
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type 'cuda' requested but CUDA is not "
                           "available")
    if not dist.is_initialized():
        raise ValueError("torch.distributed is not initialized: call "
                         "initialize_distributed or init_process_group first")


def make_mesh(frame: int = 1, tile: int = 1, disp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh with dims (frame, tile, disp) over the first frame*tile*disp
    ranks of the world; raises ValueError when the world holds fewer.
    ``frame`` is outermost (frames are independent, the cheapest axis to
    put across hosts) and ``disp`` innermost (a collective every DP
    step)."""
    _check_device_type(device_type)
    n = frame * tile * disp
    if min(frame, tile, disp) < 1:
        raise ValueError(f"mesh dims must be >= 1, got ({frame}, {tile}, "
                         f"{disp})")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} processes, have {world}")
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(frame, tile, disp),
                      mesh_dim_names=(FRAME_AXIS, TILE_AXIS, DISP_AXIS))


def _ranks_per_host(device_type: str) -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE where a launcher set it, else
    one rank per CUDA device, else the whole world (one CPU host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if device_type == "cuda":
        return min(torch.cuda.device_count(), dist.get_world_size())
    return dist.get_world_size()


def make_global_mesh(tile: int = 1, disp: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """Mesh over the whole world: the frame axis spans hosts (frames are
    independent) and each (tile, disp) block stays within a host, whose
    ranks are contiguous. Raises ValueError when the world is not a
    multiple of tile*disp or a block would span hosts."""
    _check_device_type(device_type)
    world = dist.get_world_size()
    per = tile * disp
    if world % per:
        raise ValueError(f"world size {world} not divisible by "
                         f"tile*disp={per}")
    local = _ranks_per_host(device_type)
    if per > local and world > local:
        raise ValueError(
            f"tile*disp={per} spans hosts ({local} ranks per host); keep "
            "the halo and argmin collectives within a host by sharding "
            "frames across hosts instead")
    return make_mesh(frame=world // per, tile=tile, disp=disp,
                     device_type=device_type)
