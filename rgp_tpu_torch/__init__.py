"""rgp_tpu_torch: the PyTorch/CUDA port of :mod:`rgp_tpu`.

Each module mirrors the layout and names of its counterpart in ``rgp_tpu``
(``rgp_tpu/linalg.py`` -> ``rgp_tpu_torch/linalg.py`` and so on); the JAX
package is the reference each module is tested against in f64 on the CPU.

Entry points that create tensors (``init``, the models' ``init_params``,
``data.datasets.standardized_tensors``, ``convert.params_from_jax``,
``bench.harness.run``) run on the card unless the caller passes
``device="cpu"``; every other function follows the device of its input
tensors. The RBF Psi2 time sum on uncertain inputs runs in hand-written CUDA
kernels (``ops/cuda/psi2.py``, ``csrc/psi2_{fwd,bwd}.cu``) for float32 CUDA
tensors.

Public surface:

    import rgp_tpu_torch as rgp
    cfg    = rgp.DeepRGP(wins=[0, 20], u_win=20, y_dim=Dy, u_dim=Du,
                         num_inducing=100, back_cstr=False)
    params = rgp.init(cfg, Y, U)
    fit    = rgp.fit(lambda p: -rgp.elbo(cfg, p, Y, U), params, iters=10_000)
    sim    = rgp.freerun(cfg, fit.params, Y, U, U_test)      # means + vars
    post   = rgp.sample_nuts(cfg, fit.params, Y, U, seed, n_chains=8)
    traj   = rgp.smc(cfg, fit.params, Y, U, U_test, Y_test, generator,
                     n_particles=1024, mesh=mesh)

Config 4 (minibatch SVI with natural-gradient q(u)): ``rgp.svgp`` with
``rgp_tpu_torch.train.fit_minibatch(..., natgrad_block="qu")``, or the
harness, ``python -m rgp_tpu_torch.bench --task long_corpus --method
svgp_natgrad``.

Config 5 (NUTS over the hyperparameters, SMC over latent trajectories):
``rgp_tpu_torch.sample.api.sample_nuts`` / ``smc``, or ``python -m
rgp_tpu_torch.bench.sampling --what nuts|smc``.

Sharding (``rgp_tpu_torch.parallel``): one process per rank over
``torch.distributed``, every rank calling the same function with the same
global tensors; ``init_distributed(backend, ...)`` once a process, then
``make_mesh(data=, chain=, particle=)``. The time-sharded collapsed bound
(``data_parallel_collapsed_elbo``), the sequence-sharded RGP bound
(``parallel.sequence_sharded_rgp_elbo``), the inducing-sharded bound
(``parallel.inducing_sharded_collapsed_elbo``), chain-sharded NUTS
(``sample.api.nuts_sharded``) and particle-sharded SMC
(``smc_filter_sharded``, ``sample.api.smc(..., mesh=)``).
"""

from . import kernels, linalg, params
from .data import datasets
from .data.windows import Standardizer, narx_design
from .models import gp, gp_narx, sparse_gp, svgp
from .models.rgp import RGPConfig, elbo, freerun
from .models.rgp import deep_rgp_config as DeepRGP
from .models.rgp import init_params as init
from .ops.psi_stats import PsiStats, psi_statistics
from .parallel.mesh import data_parallel_collapsed_elbo, init_distributed, make_mesh
from .sample.api import sample_hmc, sample_nuts, smc
from .sample.nuts import nuts_sample
from .sample.smc import smc_filter_sharded
from .train import fit_adam as fit
from .train import fit_scipy_lbfgs

__version__ = "0.1.0"

__all__ = [
    "DeepRGP",
    "RGPConfig",
    "init",
    "elbo",
    "freerun",
    "fit",
    "fit_scipy_lbfgs",
    "sample_nuts",
    "sample_hmc",
    "smc",
    "nuts_sample",
    "make_mesh",
    "init_distributed",
    "data_parallel_collapsed_elbo",
    "smc_filter_sharded",
    "psi_statistics",
    "PsiStats",
    "Standardizer",
    "narx_design",
    "datasets",
    "kernels",
    "linalg",
    "params",
    "gp",
    "sparse_gp",
    "gp_narx",
    "svgp",
]
