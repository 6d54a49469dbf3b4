"""The device mesh and mesh-split batched inference (the inference half
of ``tpu21cmvae/parallel``). Data-parallel training and walkers sharded
over several devices (``train_dp.py``, the samplers' ``mesh=``) wait for
the port of its distributed half (``torch.distributed``)."""

from tpu21cmvae_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    make_mesh,
    multihost_init,
    replicate,
    shard_batch,
)
from tpu21cmvae_torch.parallel.inference import ShardedEmulator  # noqa: F401
