"""Data sources of the port."""
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
from repro_torch.data.synthetic import synthetic_token_batches  # noqa: F401
