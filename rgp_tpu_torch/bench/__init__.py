"""Benchmarks of the port on the card (``config1``: the twin of the root
``bench.py``)."""
