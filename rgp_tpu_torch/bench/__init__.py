"""Benchmarks of the port on the card: ``harness`` (``python -m
rgp_tpu_torch.bench``, the twin of ``rgp_tpu.bench.harness`` for configs 1-4),
``config1`` (the twin of the root ``bench.py``) and ``sampling`` (``python -m
rgp_tpu_torch.bench.sampling``, the twin of ``rgp_tpu.bench.sampling`` for
config 5)."""
