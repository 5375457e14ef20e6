from .sharding import (LOGICAL_RULES, ShardSpec, batch_specs,  # noqa: F401
                       cache_specs, data_axis_names, divisible_axes,
                       fsdp_shardings, gather_leaf, gather_tree, leaf_nbytes,
                       local_slice, local_tree, mesh_axes_for, mesh_shape,
                       shardings_for_tree, spec_for, train_shard_spec,
                       zero1_shardings)
