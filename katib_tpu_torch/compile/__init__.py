"""Compile amortization (port of ``katib_tpu/compile/``).

- :mod:`katib_tpu_torch.compile.buckets` quantizes cohort width K onto a
  few padded power-of-two sizes, so cohorts of different K share one
  program;
- :mod:`katib_tpu_torch.compile.registry` records the signatures this
  process has warmed and classifies each trial's first step warm/cold (warm
  means warmed in this process: a CUDA-graph capture dies with it);
- :mod:`katib_tpu_torch.compile.prewarm` runs a best-effort background
  worker that warms up and captures upcoming groups' programs through the
  train function's prewarm twin while earlier trials train;
- :mod:`katib_tpu_torch.compile.artifacts` carries the port's compiled
  kernel libraries (``ops/_build.py``) across processes and hosts in a
  content-addressed, tiered artifact cache.
"""
