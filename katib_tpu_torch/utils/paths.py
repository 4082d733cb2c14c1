"""The port's artifact-tree root (port of ``katib_tpu/utils/paths.py``).

One definition of the root for every writer and reader of the port's run
artifacts (the dashboard's flagship-progress endpoint reads
``<root>/flagship/run_progress.jsonl``), so a ``KATIB_ARTIFACTS_DIR``
redirect moves producers and consumers together.

The default is the port's own tree, ``artifacts_torch/`` at the root of
the checkout the package was imported from (ignored by git).  It is never
the repository's ``artifacts/``, which holds the JAX package's TPU runs:
no TPU number is a figure of the port.  Unlike the JAX resolver it does not
search upward from the working directory for a ``katib_tpu/`` checkout.
"""

from __future__ import annotations

import os

DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts_torch",
)


def artifacts_root() -> str:
    """The artifact tree root; ``KATIB_ARTIFACTS_DIR`` redirects it."""
    return os.environ.get("KATIB_ARTIFACTS_DIR") or DEFAULT_ROOT
