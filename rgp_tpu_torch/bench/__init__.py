"""Benchmarks of the port on the card, each the twin of its ``rgp_tpu.bench``
module: ``harness`` (``python -m rgp_tpu_torch.bench``, configs 1-4),
``config1`` (the root ``bench.py``), ``sampling`` (config 5), ``serving``,
``layer_step``, ``roofline``, ``multimodality``, ``posterior_check`` and
``all`` (the sweep); and the port's own tools ``psi2_times``,
``serve_times`` and ``order_spread``."""
