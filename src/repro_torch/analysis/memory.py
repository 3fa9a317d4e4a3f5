"""Bytes live while a step runs, counted by storage.

The counterpart of XLA's ``memory_analysis`` for an eager step: a
``TorchDispatchMode`` that sees every aten op's outputs and counts each new
storage's bytes from when an op makes it until the last tensor on it dies
(a weak reference to the storage).  Views share their base's storage and
an in-place op returns a storage already counted, so neither adds bytes.
It reads shapes only, so it counts a step on ``meta`` tensors as it
counts the same step on real ones: ``peak`` is what
``torch.cuda.max_memory_allocated`` would read for a process that holds
only this step, short of the allocator's rounding and a kernel's own
scratch, except the scratch ``SCRATCH`` names: what a CUDA kernel
allocates through the caching allocator below the dispatcher, counted
live with the op's outputs while the op runs.

    tracker = MemoryTracker()
    argument_bytes = tracker.hold(params, opt_state, batch)
    with tracker:
        out = step()
    tracker.peak, tracker.live
"""
from __future__ import annotations

import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.trace import tensors_in


def storage_bytes(*trees) -> int:
    """The bytes of the distinct storages under the tensors of ``trees``."""
    seen: dict[int, int] = {}
    for t in tensors_in(list(trees)):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _softmax_backward_scratch(args) -> int:
    """``softmax_backward_cuda_out``'s scratch: grad · output, an
    output-sized buffer, and a contiguous copy of a strided grad
    (``scripts/softmax_scratch.py`` measures it on the card)."""
    grad, out = args[0], args[1]
    n = out.numel() * out.element_size()
    return n + (0 if grad.is_contiguous()
                else grad.numel() * grad.element_size())


# aten ops whose CUDA kernels allocate scratch that no dispatch mode sees
SCRATCH = {torch.ops.aten._softmax_backward_data.default:
           _softmax_backward_scratch}


class MemoryTracker(TorchDispatchMode):
    """``live``: the bytes of the storages counted and not yet freed;
    ``peak``: the most of them at once, each op's outputs counted while
    its inputs are still held; ``at_peak``: what ``watch()`` (a count of
    some bytes of interest, e.g. a cache's) read when ``peak`` was
    reached; ``peak_by_dtype``: the bytes live at the peak by the dtype
    of the tensor that first counted each storage."""

    def __init__(self, watch=None):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.at_peak = 0
        self.peak_by_dtype: dict[str, int] = {}
        self._watch = watch
        self._sizes: dict[int, int] = {}
        self._dtypes: dict[int, str] = {}
        self._by_dtype: dict[str, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    def hold(self, *trees) -> int:
        """Count the storages under the tensors of ``trees`` as live (a
        step's arguments); returns their bytes, each storage once."""
        before = self.live
        for t in tensors_in(list(trees)):
            self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tensors_in(out):
            self._track(t)
        scratch = SCRATCH.get(func)
        if scratch is not None:
            self._transient(scratch(args),
                            str(out.dtype).removeprefix("torch."))
        return out

    def _transient(self, n: int, dtype: str) -> None:
        """``n`` bytes live beside the live storages for a moment."""
        if self.live + n > self.peak:
            self.peak = self.live + n
            self.peak_by_dtype = dict(self._by_dtype)
            self.peak_by_dtype[dtype] = self.peak_by_dtype.get(dtype, 0) + n
            if self._watch is not None:
                self.at_peak = self._watch()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), st.nbytes()
        old = self._sizes.get(key)
        if old is None:
            self._refs[key] = weakref.ref(st, functools.partial(self._freed,
                                                                key))
            self._dtypes[key] = str(t.dtype).removeprefix("torch.")
        self._sizes[key] = n
        self.live += n - (old or 0)
        dtype = self._dtypes[key]
        self._by_dtype[dtype] = self._by_dtype.get(dtype, 0) + n - (old or 0)
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by_dtype = dict(self._by_dtype)
            if self._watch is not None:
                self.at_peak = self._watch()

    def _freed(self, key: int, _ref) -> None:
        n = self._sizes.pop(key, 0)
        self.live -= n
        dtype = self._dtypes.pop(key, None)
        if dtype is not None:
            self._by_dtype[dtype] -= n
        self._refs.pop(key, None)
