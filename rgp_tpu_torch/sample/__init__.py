"""Samplers (port of ``rgp_tpu/sample``): ``api`` (``make_rgp_potential``,
``sample_nuts``, ``sample_hmc``, ``smc``), ``nuts``, ``hmc``, ``smc`` and
``diagnostics``. Tempered SMC and the sharded samplers are not ported."""
