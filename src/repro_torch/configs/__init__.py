"""Published model configurations of the port: copies of ``repro.configs``
(pure data), plus the port's ``gcn_paper``."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import get_config, list_archs  # noqa: F401
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: F401
