"""Utilities (port of ``rgp_tpu/utils``): ``checkpoint`` (save and resume a
state tree), ``metrics`` (JSONL logging), ``profiling`` (``torch.profiler``
traces and named regions), ``plotting`` (matplotlib, imported lazily) and
``checkgrad`` (finite-difference gradient checks)."""
