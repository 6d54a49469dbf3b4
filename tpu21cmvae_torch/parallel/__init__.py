"""The device mesh, mesh-split batched inference and data-parallel
training (the port of ``tpu21cmvae/parallel``). The samplers' and fits'
``mesh=`` split their likelihood's rows over a mesh
(``sampling/_common.py::_shard_rows``); several processes join one mesh
through :func:`multihost_init` (``torch.distributed``)."""

from tpu21cmvae_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    make_mesh,
    multihost_init,
    replicate,
    shard_batch,
)
from tpu21cmvae_torch.parallel.inference import ShardedEmulator  # noqa: F401
from tpu21cmvae_torch.parallel.train_dp import (  # noqa: F401
    dp_fit,
    dp_fit_scan,
    make_dp_train_step,
)
