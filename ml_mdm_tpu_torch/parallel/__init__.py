from ml_mdm_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_mean,
    broadcast_module,
    infer_param_sharding,
    make_data_parallel_sampler,
    make_mesh,
    mesh_shape,
    sample_data_parallel,
    shard_module,
)
