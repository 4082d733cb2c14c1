"""Trial workloads' models and data."""

from katib_tpu_torch.models.transformer import TransformerLM, markov_dataset, transformer_trial

__all__ = ["TransformerLM", "markov_dataset", "transformer_trial"]
