"""Import side-effect module: registers the suggesters the port has.

Copy of ``katib_tpu/suggest/algorithms.py``: ``asha``,
``bayesianoptimization``, ``cmaes``, ``grid``, ``hyperband``, ``pbt``,
``pbt-ondevice``, ``random``, ``remote`` (``suggest/service.py``),
``sobol``, ``tpe`` and ``multivariate-tpe`` register here, ``darts`` and
``enas`` lazily from ``nas/darts/service.py`` and ``nas/enas/service.py``.
Every algorithm of the JAX registry is ported, so
:data:`UNPORTED_ALGORITHMS` is empty.  scipy (``sobol``,
``bayesianoptimization``) and scikit-learn (``bayesianoptimization``) are
imported at first use, so importing this module needs neither.
"""

from katib_tpu_torch.suggest import asha  # noqa: F401
from katib_tpu_torch.suggest import bayesopt  # noqa: F401
from katib_tpu_torch.suggest import cmaes  # noqa: F401
from katib_tpu_torch.suggest import grid  # noqa: F401
from katib_tpu_torch.suggest import hyperband  # noqa: F401
from katib_tpu_torch.suggest import pbt  # noqa: F401
from katib_tpu_torch.suggest import random_search  # noqa: F401
from katib_tpu_torch.suggest import service  # noqa: F401  (registers "remote")
from katib_tpu_torch.suggest import sobol  # noqa: F401
from katib_tpu_torch.suggest import tpe  # noqa: F401

#: registered on first use by ``base.make_suggester``
LAZY_ALGORITHMS = {
    "darts": "katib_tpu_torch.nas.darts.service",
    "enas": "katib_tpu_torch.nas.enas.service",
}

#: the JAX registry's other algorithms -> the module each would port
UNPORTED_ALGORITHMS: dict[str, str] = {}
