"""The four assigned input shapes and what step each one lowers."""
from __future__ import annotations

import dataclasses
from typing import Literal

StepKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind


INPUT_SHAPES: dict[str, InputShape] = {
    # training step (forward + backward + optimizer)
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    # forward-only prefill producing the KV cache / final state
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    # ONE new token against a seq_len cache
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    # long-context decode: sub-quadratic attention required (SSM/hybrid
    # native; dense archs run their sliding-window variant — DESIGN.md)
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
