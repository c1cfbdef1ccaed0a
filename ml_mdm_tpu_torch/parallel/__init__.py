from ml_mdm_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_mean,
    broadcast_module,
    data_axis_size,
)
