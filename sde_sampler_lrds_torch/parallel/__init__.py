from .mesh import (Mesh, batch_sharding, constrain_batch, data_axis, get_mesh, replicate,
                   replicated_sharding, shard_batch)
