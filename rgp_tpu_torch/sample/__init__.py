"""Samplers (port of ``rgp_tpu/sample``): ``api`` (``make_rgp_potential``,
``sample_nuts``, ``sample_hmc``, ``make_rgp_loglik``, ``sample_tempered``,
``smc``, and the chain-sharded ``nuts_sharded``), ``nuts``, ``hmc``, ``smc``
(``smc_filter`` and the particle-sharded ``smc_filter_sharded``), ``tempered``
and ``diagnostics``. The sharded samplers run one process per rank over
``torch.distributed`` (:mod:`rgp_tpu_torch.parallel`)."""
