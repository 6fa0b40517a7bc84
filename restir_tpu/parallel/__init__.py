from .sharding import (  # noqa: F401
    make_mesh,
    make_sharded_step,
    shard_scene,
    shard_state,
)
