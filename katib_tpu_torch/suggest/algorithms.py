"""Import side-effect module: registers the suggesters the port has.

Copy of ``katib_tpu/suggest/algorithms.py`` limited to the ported
suggesters: ``grid`` and ``random`` register here, ``darts`` lazily from
``nas/darts/service.py``.  Every other algorithm of the JAX registry is
listed in :data:`UNPORTED_ALGORITHMS` with the JAX module it would port, and
``base.make_suggester`` raises ``NotImplementedError`` naming that module.
"""

from katib_tpu_torch.suggest import grid  # noqa: F401
from katib_tpu_torch.suggest import random_search  # noqa: F401

#: registered on first use by ``base.make_suggester``
LAZY_ALGORITHMS = {
    "darts": "katib_tpu_torch.nas.darts.service",
}

#: the JAX registry's other algorithms -> the module each would port
UNPORTED_ALGORITHMS = {
    "tpe": "katib_tpu/suggest/tpe.py",
    "multivariate-tpe": "katib_tpu/suggest/tpe.py",
    "hyperband": "katib_tpu/suggest/hyperband.py",
    "asha": "katib_tpu/suggest/asha.py",
    "bayesianoptimization": "katib_tpu/suggest/bayesopt.py",
    "cmaes": "katib_tpu/suggest/cmaes.py",
    "sobol": "katib_tpu/suggest/sobol.py",
    "pbt": "katib_tpu/suggest/pbt.py",
    "pbt-ondevice": "katib_tpu/suggest/pbt.py",
    "remote": "katib_tpu/suggest/service.py",
    "enas": "katib_tpu/nas/enas/service.py",
}
