"""The model zoo of the port: the dense and attention+Mamba families."""
from repro_torch.models.transformer import Model  # noqa: F401
