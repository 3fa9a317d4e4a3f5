"""Tree checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore, save)
