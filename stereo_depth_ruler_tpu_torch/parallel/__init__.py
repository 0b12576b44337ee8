"""Scale-out over several devices: the mesh and the sharded pipeline steps
on ``torch.distributed`` (port of ``stereo_depth_ruler_tpu/parallel``)."""

from .mesh import DISP_AXIS, FRAME_AXIS, TILE_AXIS, make_mesh
from .sharded import pipeline_step_sharded, sgbm_sharded

__all__ = ["make_mesh", "FRAME_AXIS", "TILE_AXIS", "DISP_AXIS",
           "sgbm_sharded", "pipeline_step_sharded"]
