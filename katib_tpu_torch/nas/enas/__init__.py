"""ENAS: the LSTM controller, its REINFORCE trainer, the child CNN, weight
sharing, the trial and the suggester (port of ``katib_tpu.nas.enas``)."""

from katib_tpu_torch.nas.enas.child import DEFAULT_OPERATIONS, EnasChild, child_from_arc  # noqa: F401
from katib_tpu_torch.nas.enas.controller import (  # noqa: F401
    Arc,
    ControllerConfig,
    arc_from_json,
    arc_to_json,
    make_reinforce,
    sample_arc,
)
from katib_tpu_torch.nas.enas.service import EnasSuggester  # noqa: F401
from katib_tpu_torch.nas.enas.trial import enas_trial  # noqa: F401
