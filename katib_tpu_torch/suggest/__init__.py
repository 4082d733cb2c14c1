from katib_tpu_torch.suggest.base import (  # noqa: F401
    SearchExhausted,
    Suggester,
    SuggesterError,
    SuggestionsNotReady,
    make_suggester,
    registered_algorithms,
)
from katib_tpu_torch.suggest.space import SpaceEncoder  # noqa: F401
