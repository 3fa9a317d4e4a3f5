"""Bridge from a built ``ParallelADMMTrainer`` to an analysis run.

The port's counterpart of ``repro.analysis.trainer``.
``trainer_expectations`` distils the trainer's *host-side* contract —
transport mode, exchange-plan rounds (the active sub-plan under
minibatching), scheduled wire bytes, layout shape facts, the state that
must not outlive a step, per-shard kernel specs with their localized tables
— into the expectations dict the rule registry checks a recorded step
against; every key computed from host data equals the reference's on the
same graph, partition and config (the kernels entries carry the port's
launch specs, and the packed tables row offsets where the reference's
carry 8-row offsets).  ``record_step`` records one ``step()`` under the
op-trace recorder; ``analyze_trainer`` runs the registry over it.
"""
from __future__ import annotations

import weakref
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.analysis import trace
from repro_torch.analysis.findings import Report, Waiver
from repro_torch.analysis.registry import AnalysisContext, run_rules


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _kernel_entries(tr: Any, n_shards: int) -> list[dict]:
    """One ELL-kernel spec per shard the trainer hosts (every shard on the
    loopback, its own on a rank), with that shard's tables (localized
    slots under multi-shard p2p, global ids otherwise; on the packed wire
    the receive-plane row offsets, and the fused spec first under
    ``fused``)."""
    from repro_torch.kernels.community_spmm import (copy_align,
                                                    ell_fused_spec,
                                                    ell_packed_spec, ell_spec)

    data = tr.data
    csr = tr.layout.compress()
    m, max_deg, n_pad = csr.num_parts, csr.max_deg, tr.layout.n_pad
    k = m // n_shards
    bb = data.ell_blocks.element_size()
    idx = np.asarray(csr.ell_indices)
    msk = np.asarray(csr.ell_mask)
    z_lanes = m
    plan = tr._plan
    packed_wire = bool(tr.packed and n_shards > 1 and plan is not None)
    if tr.transport == "p2p" and n_shards > 1 and plan is not None:
        idx = plan.localize_indices(csr.ell_indices, csr.ell_mask)
        z_lanes = plan.r_pad
    rows, nbrs = (np.asarray(x) for x in csr.ell_row_counts())
    c = max(tr.cfg.layer_dims)
    # rows of a fresh allocation start 256-byte aligned: the row stride
    # decides the copy widths
    z_align = copy_align(0, 4 * c)
    a_align = copy_align(0, bb * n_pad)
    if packed_wire:
        off = np.asarray(plan.localized_offsets(csr.ell_indices,
                                                csr.ell_mask))
    entries = []
    for s in tr.comm.shards:
        sl = slice(s * k, (s + 1) * k)
        if packed_wire:
            # the packed trainer's aggregation reads the receive *plane*
            # through row offsets, not a strided (z_lanes, n_pad, C)
            spec = ell_packed_spec(k, max_deg, n_pad, c,
                                   plan.recv_plane_rows, block_bytes=bb,
                                   z_align=z_align, a_align=a_align)
            scalars = {"ell_offsets": off[sl], "ell_mask": msk[sl],
                       "row_counts": rows[sl], "nbr_counts": nbrs[sl]}
            if tr.config.fused:
                # the fused pass shares the packed tables; the widest
                # feature pair bounds its shared memory
                fspec = ell_fused_spec(k, max_deg, n_pad, c, c,
                                       plan.recv_plane_rows, block_bytes=bb)
                entries.append({"spec": fspec, "scalars": dict(scalars)})
        else:
            spec = ell_spec(k, max_deg, n_pad, c, z_lanes, block_bytes=bb,
                            z_align=z_align, a_align=a_align)
            scalars = {"ell_indices": idx[sl], "ell_mask": msk[sl],
                       "row_counts": rows[sl], "nbr_counts": nbrs[sl]}
        entries.append({"spec": spec, "scalars": scalars})
    return entries


def trainer_expectations(tr: Any) -> dict[str, Any]:
    """Expectations dict for the built-in rules, from the trainer's
    host-side plan and layout (see ``AnalysisContext`` for the keys)."""
    from repro_torch.core import messages
    from repro_torch.core.parallel import gathered_widths

    n_shards = tr.n_shards
    hosted = tr.comm.shards
    m = tr.layout.num_parts
    n_pad = tr.layout.n_pad
    cs = gathered_widths(tr.cfg)
    max_c = max(tr.cfg.layer_dims)
    if tr.data.ell_mask is not None:
        max_deg = int(tr.data.ell_mask.shape[1])
    else:
        max_deg = m
    exp: dict[str, Any] = {
        "pad_mode": tr.pad_mode,
        "compressed": tr.compressed,
        "m_total": m,
        "n_shards": n_shards,
        "lanes": m // n_shards,
        "n_pad": n_pad,
        "max_deg": max_deg,
        "num_gathers": len(cs),
        "dense_adjacency_allowed": not tr.compressed,
        "expect_donated": (".zs", ".u"),
    }
    if len(hosted) < n_shards:
        # a rank of the process transport: its bounds are one shard's
        exp["hosted_shards"] = len(hosted)
    # the minibatch step runs a restricted round schedule
    # (messages.restrict_exchange): expectations come from the active
    # sub-plan, so permute-schedule proves the sampled step touches no
    # unsampled shard pair
    plan = getattr(tr, "_active_plan", None) or tr._plan
    if n_shards > 1:
        # one shard moves nothing across a wire: the transport contract is
        # only meaningful (and checkable) on more than one
        exp["transport"] = tr.transport
        item = 2 if tr.config.comm_bf16 else 4
        if len(hosted) < n_shards:
            # a rank: its own sends, and the rounds it takes part in
            if plan is not None:
                exp["collective_budget_bytes"] = int(sum(
                    r.rows_pad * c * item for r in plan.rounds
                    for src, _ in r.pairs if src in hosted for c in cs))
            else:
                exp["collective_budget_bytes"] = \
                    int(tr.comm_stats["full_bytes"]) // n_shards
        elif tr.transport == "p2p":
            if plan is not tr._plan:
                wire = messages.exchange_bytes(plan, cs, itemsize=item)
                exp["collective_budget_bytes"] = int(wire["wire_bytes"])
            else:
                exp["collective_budget_bytes"] = \
                    int(tr.comm_stats["wire_bytes"])
        else:
            exp["collective_budget_bytes"] = int(tr.comm_stats["full_bytes"])
        if plan is not None:
            exp["round_pairs"] = [
                tuple(r.pairs) for r in plan.rounds
                if any(s in hosted or d in hosted for s, d in r.pairs)]
        # the only legitimate psums are the W update's: weight gradients
        # and line-search scalars
        w_bytes = sum(w.numel() * w.element_size()
                      for w in tr.state.weights)
        exp["allreduce_max_bytes"] = 2 * w_bytes + 4096
    # packed resident state: only meaningful when the packed plane feeds
    # the wire (multi-shard p2p)
    exp["state_packed"] = bool(tr.packed and tr.transport == "p2p"
                               and n_shards > 1 and tr._plan is not None)
    if exp["state_packed"]:
        exp["packed_rows_bound"] = int(tr._plan.r_pad)
    # fused aggregation→GEMM: only the W-update may hand an aggregated
    # stack to a product (its line search re-evaluates the GEMM under a
    # varying W) — one aggregate per layer
    exp["fused"] = bool(exp["state_packed"] and tr.config.fused)
    if exp["fused"]:
        exp["fused_max_agg_handoffs"] = int(tr.cfg.num_layers)
    # largest legitimate resident buffers: the adjacency store, the full
    # Z/U state stack, and one gathered payload; anything 4x past their
    # max is a blow-up
    st = tr.state
    state_bytes = sum(z.numel() * z.element_size() for z in st.zs) \
        + st.u.numel() * st.u.element_size()
    gather_stack = m * n_pad * max_c * 4
    exp["hbm_intermediate_budget"] = 4 * max(
        int(tr.data.adjacency_nbytes), state_bytes, gather_stack)
    if tr.compressed:
        exp["kernels"] = _kernel_entries(tr, n_shards)
    return exp


_STATE_FIELDS = ("weights", "zs", "u", "taus", "thetas")


def _state_refs(state) -> dict[str, weakref.ref]:
    refs = {}
    for name in _STATE_FIELDS:
        val = getattr(state, name)
        if isinstance(val, tuple):
            for i, t in enumerate(val):
                refs[f"[0].{name}[{i}]"] = weakref.ref(t)
        else:
            refs[f"[0].{name}"] = weakref.ref(val)
    return refs


def record_step(tr: Any) -> tuple[trace.Trace, dict[str, Any]]:
    """Record one ``tr.step()`` under the op-trace recorder: the trace and
    the trainer's expectations for it (taken after the step, so that under
    minibatching they hold the sub-plan the step ran).

    The step advances the trainer.  ``args_donated`` records which of the
    previous state's tensors are freed once the step returns, so a caller
    that holds ``tr.state`` across this call sees them kept."""
    refs = _state_refs(tr.state)
    with trace.record() as tape:
        tr.step()
    exp = trainer_expectations(tr)
    exp["args_donated"] = {p: r() is None for p, r in refs.items()}
    return tape, exp


def analyze_trainer(tr: Any, *, config: str = "",
                    rules: Optional[Sequence[str]] = None,
                    waivers: Sequence[Waiver] = ()) -> Report:
    """Record one step of ``tr`` (``record_step``) and run the rule
    registry over it against the trainer's own expectations."""
    tape, exp = record_step(tr)
    ctx = AnalysisContext(trace=tape, expectations=exp,
                          config=config or f"{tr.transport}/{tr.pad_mode}")
    return run_rules(ctx, rules=rules, waivers=waivers)
