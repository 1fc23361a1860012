"""Data sources of the port (``repro.data``): the synthetic token
stream that the training launcher feeds."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
