"""Built-in rule families.  Importing a module registers its rules."""
from repro_torch.analysis.rules import collective, kernel, memory, precision

__all__ = ["collective", "kernel", "memory", "precision"]
