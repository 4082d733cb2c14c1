"""The dashboard and its REST backend (port of ``katib_tpu/ui``)."""

from katib_tpu_torch.ui.backend import UiServer, start_ui  # noqa: F401
