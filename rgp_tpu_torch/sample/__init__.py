"""Samplers (port of ``rgp_tpu/sample``): ``api`` (``make_rgp_potential``,
``sample_nuts``, ``sample_hmc``, ``make_rgp_loglik``, ``sample_tempered``,
``smc``), ``nuts``, ``hmc``, ``smc``, ``tempered`` and ``diagnostics``. The
sharded samplers are not ported."""
