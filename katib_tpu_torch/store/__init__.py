from katib_tpu_torch.store.base import MemoryObservationStore, ObservationStore  # noqa: F401
from katib_tpu_torch.store.sqlite import SqliteObservationStore  # noqa: F401
