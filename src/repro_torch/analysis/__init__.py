"""repro_torch.analysis — an invariant linter over an op trace of a step.

The port's counterpart of ``repro.analysis``.  It proves the transport,
memory, precision and kernel-launch properties the trainer's speed rests
on, against a trace recorded while one real step runs
(``analysis.trace``: every aten op, plus events for the hand-written
kernel launches, the loopback transport rounds and the W-update's shard
sum).  Entry points:

  * ``analyze_trainer(tr)`` — record one step of a built
    ``ParallelADMMTrainer`` (``record_step``) and lint it against its own
    host-side plan;
  * ``analyze_trace(tape, expectations)`` — lint any recorded trace;
  * ``no_findings(report, rule=...)`` — the pytest-side assertion;
  * ``launch/analyze.py`` — the CLI over the benchmark configs.

Rule catalogue (port id — what it reads in the trace — reference id):

  collective/no-allgather-under-p2p  all-gather events under p2p
      — collective/no-allgather-under-p2p
  collective/zero-collectives  any transport or shard-sum event (serving)
      — collective/zero-collectives
  collective/allreduce-payload  each shard's operand of a shard sum
      — collective/allreduce-payload
  collective/permute-schedule  the exchange rounds' pair sets = the plan's
      — collective/permute-schedule
  collective/permute-count  rounds run = rounds x gathers (warning)
      — collective/permute-count
  collective/payload-budget  recorded wire bytes <= the plan's wire bytes
      — collective/payload-budget
  memory/no-dense-adjacency  tensors with trailing (n_pad, n_pad) dims
      — memory/no-dense-adjacency
  memory/packed-resident-state  computed (rows, n_pad, C) stacks <= the
      shards' receive rows — memory/packed-resident-state
  memory/fused-no-intermediate  aggregation-kernel outputs reaching a
      product (dataflow over tensor ids) — memory/fused-no-intermediate
  memory/hbm-intermediate-budget  computed tensors' bytes
      — memory/hbm-intermediate-budget
  memory/no-full-graph-tensors  any tensor's leading dim (serving hit)
      — memory/no-full-graph-tensors
  memory/donated-inputs  the previous state's Z/U freed after the step
      — memory/donated-inputs
  memory/host-transfer  host reads outside a line-search decision
      — memory/host-transfer
  precision/bf16-dot-accumulate  products and kernels over bf16 operands
      — precision/bf16-dot-accumulate
  precision/bf16-reduce  reductions kept in bf16 (warning)
      — precision/bf16-reduce
  precision/no-f64  any f64 tensor — precision/no-f64
  precision/trace-dataflow  bf16 values into a product without an upcast,
      f64 leaks — precision/jaxpr-dataflow
  kernel/index-bounds  launch specs' grid corners and live table values
      — pallas/index-bounds
  kernel/smem-budget  launch specs' shared memory <= the card's per-block
      limit — pallas/vmem-budget
  kernel/copy-alignment  cp.async operands with rows not 16-byte aligned
      (warning) — pallas/tile-alignment
"""
from repro_torch.analysis.findings import (Finding, Report, Severity, Waiver,
                                           no_findings)
from repro_torch.analysis.registry import (AnalysisContext, Rule, all_rules,
                                           analyze_trace, get_rule, rule,
                                           run_rules)
from repro_torch.analysis.trainer import (analyze_trainer, record_step,
                                          trainer_expectations)

# port rule id -> the reference's (repro.analysis) id of the same property
REFERENCE_IDS = {
    "precision/trace-dataflow": "precision/jaxpr-dataflow",
    "kernel/index-bounds": "pallas/index-bounds",
    "kernel/smem-budget": "pallas/vmem-budget",
    "kernel/copy-alignment": "pallas/tile-alignment",
}


def reference_id(port_id: str) -> str:
    return REFERENCE_IDS.get(port_id, port_id)


__all__ = [
    "AnalysisContext", "Finding", "REFERENCE_IDS", "Report", "Rule",
    "Severity", "Waiver", "all_rules", "analyze_trace", "analyze_trainer",
    "get_rule", "no_findings", "record_step", "reference_id", "rule",
    "run_rules", "trainer_expectations",
]
