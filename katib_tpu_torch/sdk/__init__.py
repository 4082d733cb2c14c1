"""User-facing SDK of the port (reference ``sdk/python/v1beta1/kubeflow/katib``):
``tune()`` and ``KatibClient`` over the port's orchestrator, the ``search``
helpers, and the YAML spec loader (``yaml_spec``).  Trials run on ``cuda``
unless the caller passes ``device="cpu"``; ``mesh=`` runs every trial on
that mesh (``parallel/mesh.py``; a ``trial`` axis > 1 raises, ROADMAP item
9b)."""

from katib_tpu_torch.sdk import search
from katib_tpu_torch.sdk.client import KatibClient, make_experiment_spec, tune

__all__ = ["KatibClient", "make_experiment_spec", "search", "tune"]
