"""Faults planted in the program underneath a run, to show that the
comparison of ``check.py`` fails them.  Each is a hook that the driver
calls with the trainer once it is built (in every rank's process), and
that breaks the timed path from then on:

* ``unchanged``: a step returns its state unchanged;
* ``half_batch``: half of the training nodes (each community's slots in
  the upper half of its block) are left out of the loss, the mean taken
  over the rest;
* ``altered``: an answer altered where it is produced: the first entry
  of every aggregation's output gains half the output's largest value;
* ``no_exchange``: the exchange between the ranks left out: the rows the
  other ranks send are never landed, and each rank sums the W objective
  over its own lanes only (ranks only).

``control.py`` reads them on the card; the tests read them on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def unchanged(trainer) -> None:
    trainer.next_state = lambda state=None, use_kernel=None: trainer.state


def half_batch(trainer) -> None:
    body, lay = trainer._body, trainer.layout
    n = int(lay.n_pad)
    keep_slot = np.arange(n) < n // 2
    perm = np.asarray(lay.perm).reshape(-1, n)
    train = np.asarray(trainer.graph.train_mask)
    kept = sum(int(train[row[keep_slot & (row >= 0)]].sum()) for row in perm)
    keep = torch.as_tensor(keep_slot.astype(np.float32),
                           device=body.mask.device)
    body.mask = body.mask * keep
    body.denom = torch.tensor(float(kept), device=body.denom.device)


def altered(trainer) -> None:
    from repro_torch.kernels import ops

    def alter(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs).clone()
            flat = out.view(-1)
            flat[0] = flat[0] + 0.5 * out.abs().max()
            return out
        return call

    for name in ("community_spmm_ell", "community_spmm_ell_packed"):
        setattr(ops, name, alter(getattr(ops, name)))


def no_exchange(trainer) -> None:
    from repro_torch.core import messages

    def land(self, buf, posted, in_place):
        for q in posted[0]:
            q.wait()
        return buf

    messages.ProcessTransport._land = land
    trainer._body.psum = lambda part: part


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "no_exchange": no_exchange}
