from katib_tpu_torch.earlystop.medianstop import MedianStop  # noqa: F401
from katib_tpu_torch.earlystop.rules import (  # noqa: F401
    EarlyStopper,
    RuleEvaluator,
    make_early_stopper,
    register_early_stopper,
)
