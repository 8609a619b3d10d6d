"""Multi-device stepping and data-parallel stage 2 over
``torch.distributed`` (port of mpmavatar_tpu/parallel)."""

from .sharded import (ShardedClothState, UniformModel,  # noqa: F401
                      make_sharded_cloth_state, make_sharded_frame,
                      make_sharded_material_step, shard_state)
