"""Device meshes for the sharded control plane (``control_plane_mesh``).

The reference's model-parallel specs (``param_specs``, ``cache_specs``,
``state_specs``) are not ported yet (ROADMAP: modules queue, item 6).
"""
from repro_torch.distributed.sharding import ShardMesh, control_plane_mesh

__all__ = ["ShardMesh", "control_plane_mesh"]
