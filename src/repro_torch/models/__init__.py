"""Language-model substrate of the port: the ``ssm`` (Mamba-2) path of
``repro.models``."""
