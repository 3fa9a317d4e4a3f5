"""Training log shared by the trainers (``repro.core.serial.TrainLog``).

The serial (global-form) trainer itself comes in a later slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainLog:
    epoch: list = dataclasses.field(default_factory=list)
    train_acc: list = dataclasses.field(default_factory=list)
    test_acc: list = dataclasses.field(default_factory=list)
    lagrangian: list = dataclasses.field(default_factory=list)
    residual: list = dataclasses.field(default_factory=list)
    epoch_time_s: list = dataclasses.field(default_factory=list)

    def as_dict(self):
        return dataclasses.asdict(self)
