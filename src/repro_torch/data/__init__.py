"""Data sources of the port."""
from repro_torch.data.synthetic import synthetic_token_batches  # noqa: F401
