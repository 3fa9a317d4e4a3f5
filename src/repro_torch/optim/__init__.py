"""First-order optimizers of the backprop baselines (``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, make  # noqa: F401
