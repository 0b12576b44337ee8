"""The cases of tests/test_torch_parallel.py that run on a gloo world of CPU
processes (``stereo_depth_ruler_tpu_torch.parallel.dryrun.spawn_world``).

The spawned processes import this module to find ``run_cases``, so it
imports no JAX: the test holds the results to the JAX package in its own
process. Every rank builds every mesh, in the same order; a rank that is
no member of a mesh skips that mesh's case.
"""

import sys

import numpy as np

from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch.ops.remap import build_remap_grids
from stereo_depth_ruler_tpu_torch.parallel.mesh import (
    initialize_distributed, make_global_mesh, make_mesh)
from stereo_depth_ruler_tpu_torch.parallel.sharded import (
    pipeline_step_sharded, sgbm_sharded)

# tests/test_parallel.py's PARAMS
PARAMS = dict(num_disparities=16, block_size=3, p1=72, p2=288,
              speckle_window_size=20, speckle_range=1)

# name -> (mesh (frame, tile, disp), sgbm_sharded keywords); the frame
# axis replicates the pair, so that every mesh holds all eight ranks
SHARDED = {
    "exact_tile4": ((2, 4, 1), dict(exact=True)),
    "exact_disp4": ((2, 1, 4), dict(exact=True)),
    "exact_tile2_disp2": ((2, 2, 2), dict(exact=True)),
    "halo16_tile2_disp2": ((2, 2, 2), dict(halo=16)),
    "halo8_tile4": ((2, 4, 1), dict(halo=8)),
    "route_halo5_tile2": ((4, 2, 1), dict(halo=5, kernel="cuda")),
    "route_halo16_tile2": ((4, 2, 1), dict(halo=16, kernel="cuda")),
    "route_tile1": ((8, 1, 1), dict(kernel="cuda")),
    "route_halo8_tile4_nospeckle": ((2, 4, 1), dict(halo=8, kernel="cuda",
                                                    apply_speckle=False)),
}


def _numpy(out):
    return {k: v.numpy() for k, v in out.items()}


def run_cases(left, right, lefts, rights, Q, rig_kw):
    """Every case on this rank; returns {name: result} of the cases this
    rank is a member of."""
    params = SGBMParams(**PARAMS)
    out = {}
    for name, (shape, kw) in SHARDED.items():
        mesh = make_mesh(*shape, device_type="cpu")
        out[name] = sgbm_sharded(left, right, params, mesh, **kw).numpy()

    mesh = make_mesh(2, 2, 2, device_type="cpu")
    out["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    try:
        make_mesh(frame=16, tile=4, device_type="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    out["global_shape"] = tuple(make_global_mesh(tile=2, disp=2,
                                                 device_type="cpu").shape)
    out["initialize_again"] = initialize_distributed()

    step_params = SGBMParams(**dict(PARAMS, speckle_window_size=0))
    out["step"] = _numpy(pipeline_step_sharded(lefts, rights, Q, step_params,
                                               mesh, halo=8))
    rig = StereoRig.synthetic(**rig_kw)
    rects = build_remap_grids(rig, "cpu")
    out["step_wls"] = _numpy(pipeline_step_sharded(
        lefts, rights, rig.Q, step_params, mesh, halo=8, use_wls=True,
        rects=rects))
    route = make_mesh(2, 2, 1, device_type="cpu")
    if route.get_coordinate() is not None:
        out["step_wls_route"] = _numpy(pipeline_step_sharded(
            lefts, rights, rig.Q, params, route, halo=8, kernel="cuda",
            use_wls=True, rects=rects, apply_speckle=True))
    out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or
                                 m.startswith(("jax.",
                                               "stereo_depth_ruler_tpu.")))
    out["frame"] = mesh.get_coordinate()[0]
    return out


def frames(left, right):
    """tests/test_parallel.py's two frames: the pair and the pair rolled
    2 px."""
    return (np.stack([left, np.roll(left, 2, axis=1)]),
            np.stack([right, np.roll(right, 2, axis=1)]))
