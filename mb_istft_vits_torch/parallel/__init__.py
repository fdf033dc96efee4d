"""Data parallelism, the serving mesh and (data x model) sharding
(counterpart of `mb_istft_vits_tpu/parallel/`)."""

from mb_istft_vits_torch.parallel.mesh import (  # noqa: F401
    DistInfo,
    create_mesh,
    init_distributed,
    mesh_devices,
    mesh_size,
    shard_batch,
    shard_train_state_dp,
)
from mb_istft_vits_torch.parallel.tp import (  # noqa: F401
    create_2d_mesh,
    mesh_shape,
    param_shardings,
    param_spec,
    shard_train_state_tp,
)
