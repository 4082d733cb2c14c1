"""Compile amortization (port of ``katib_tpu/compile/``): so far only the
cohort shape buckets of :mod:`katib_tpu_torch.compile.buckets`.  The
signature registry, the background prewarmer and the artifact tier
(``registry.py``, ``prewarm.py``, ``artifacts.py``) are not ported yet."""
