"""Host→device data pipeline, the port of src/repro/data/pipeline.py.

A prefetching iterator over a host source of numpy batches: each batch is
placed on the device while the previous step runs, ``prefetch`` batches
ahead, under a lock.  On the card a batch goes through pinned host memory
with ``non_blocking`` copies, so the copy is queued behind the running
step instead of stalling the host; on the CPU it is a plain tensor.  With
``mesh`` (a ``launch.mesh.ProcessMesh``) each rank places only its own
rows of the global batch — the leading dim cut over the data axes, where
``batch_specs`` puts it (the reference's pipeline takes ``batch_axes``,
``("data",)``; over ranks the data-parallel step sums over every data
axis, so every data axis must cut the rows) — on the rank's device.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import batch_rows
from repro_torch.util.device import resolve_device


class TokenPipeline:
    def __init__(self, source: Iterator[dict],
                 device: "str | torch.device | None" = None,
                 prefetch: int = 2, mesh=None):
        self.source = source
        self.mesh = mesh
        self.device = resolve_device(
            device if device is not None or mesh is None
            else getattr(mesh, "device", None))
        self.prefetch = prefetch
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def _place(self, batch: dict) -> dict:
        if self.mesh is not None:
            batch = {k: v[batch_rows(self.mesh, len(v))]
                     for k, v in batch.items()}
        if self.device.type != "cuda":
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        with self._lock:
            while len(self._buf) < self.prefetch:
                self._buf.append(self._place(next(self.source)))
            return self._buf.popleft()
