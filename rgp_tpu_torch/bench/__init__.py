"""Benchmarks of the port on the card: ``harness`` (``python -m
rgp_tpu_torch.bench``, the twin of ``rgp_tpu.bench.harness`` for configs 1-3)
and ``config1`` (the twin of the root ``bench.py``)."""
