from katib_tpu_torch.orchestrator.orchestrator import Orchestrator  # noqa: F401
