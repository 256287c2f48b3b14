"""Meshes and sharding specs (``sharding``), activation-sharding hints
(``ctx``) and GPipe pipeline parallelism (``pipeline``), on one
controller: a mesh is a set of ``torch.device``s in one process."""
from repro_torch.distributed.ctx import (activation_rules, constrain,
                                         current_rules, default_decode_rules,
                                         default_train_rules)
from repro_torch.distributed.pipeline import pipeline_forward, stack_stages
from repro_torch.distributed.sharding import (DP, Mesh, NamedSharding, P,
                                              ShardedTensor, ShardMesh,
                                              batch_specs, cache_specs,
                                              control_plane_mesh, gather,
                                              param_specs, place, spec_for,
                                              state_specs)

__all__ = ["DP", "Mesh", "NamedSharding", "P", "ShardMesh", "ShardedTensor",
           "activation_rules", "batch_specs", "cache_specs", "constrain",
           "control_plane_mesh", "current_rules", "default_decode_rules",
           "default_train_rules", "gather", "param_specs", "pipeline_forward",
           "place", "spec_for", "stack_stages", "state_specs"]
