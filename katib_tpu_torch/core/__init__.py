from katib_tpu_torch.core.types import *  # noqa: F401,F403
from katib_tpu_torch.core.validation import ValidationError, validate_experiment  # noqa: F401
