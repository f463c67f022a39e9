"""Sharding over ``torch.distributed`` (port of ``rgp_tpu/parallel``): one
process per rank, every rank calling the same function with the same global
tensors. ``mesh`` (``init_distributed``, ``make_mesh``, the data-parallel
collapsed bound), ``sequence`` (the sequence-sharded RGP bound with halo
exchange), ``inducing`` (the inducing-sharded collapsed bound). The chain-
and particle-sharded samplers are ``sample.api.nuts_sharded`` and
``sample.smc.smc_filter_sharded``."""

from .inducing import inducing_sharded_collapsed_elbo, psi2_rows
from .mesh import Mesh, data_parallel_collapsed_elbo, init_distributed, make_mesh, shard_time
from .sequence import sequence_sharded_rgp_elbo

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_time",
    "data_parallel_collapsed_elbo",
    "sequence_sharded_rgp_elbo",
    "psi2_rows",
    "inducing_sharded_collapsed_elbo",
]
