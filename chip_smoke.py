#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU: train the community-ADMM GCN
(dense and ELL Parallel ADMM, Serial ADMM, a backprop baseline), serve it,
run Mamba-2 1.3B inference through the SSD scan kernel, run the attention
families (qwen2-7b at full width and depth among them) through the flash
attention kernel, and train gemma-2b at full width (Adam, and the paper's
layerwise ADMM).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA libraries from the repository's sources, one nvcc per
     source, all started together;
  2. hold every kernel against its plain PyTorch version on the card:
     the ELL kernel at the trainer's shapes, on a ragged layout, with bf16
     blocks and with masked slots whose indices point anywhere
     (max |diff| <= 1e-5 max |ref|), each case with the tile
     configuration, grid, stage ring and copy widths the launch picked
     (128 x 128 tiles at the trainer's shapes, 64 x 32 / 64 x 64 at the
     server's, 64 x 16 at C = 10); the dense launch (the ELL kernel's
     dense addressing, with the tile it picked) at the trainer's
     shapes (k = M = 3, n_pad = 4584, C = 767 / 1000 / 10), with per-lane
     masks whose absent blocks hold random values, on the ragged M = 32
     layout's blocks and neighbour mask, and through ``ops`` with a shared
     (M,) row, with no mask and on one block row (<= 1e-5 max); the
     packed-plane and fused kernels at
     the server's shapes (k = 1, D = 16, n_pad = 864, a 13,824-row plane,
     C = 767 and 1000, f32 and bf16 blocks, the halo mask) and on the
     ragged layout with masked slots re-pointed: packed vs plain
     <= 1e-5 max, fused vs the packed kernel then torch.matmul <= 1e-5 max,
     fused vs its reassociated plain version <= 1e-4 max, and fused with
     W = I bitwise equal to packed (the fused kernel runs one 32-row tile
     per thread-block cluster of up to 8 blocks);
  3. train the paper's GCN (767, 1000, 10) on the 13,752-node synthetic
     amazon_computers graph, M = 3 communities, packed state, through the
     ELL kernel, for 3 epochs; every value must be finite and the kernel
     must have launched; compare objectives and one step of the kernel path
     and the plain path from one shared state; then, on the same graph:
     dense-adjacency Parallel ADMM through the dense launch for 3 epochs
     (finite, launched, objectives of kernel and plain paths <= 1e-5 apart,
     a profiled step, and the dense launch against the strided ELL launch
     on the layout's compressed view at C = 1000, bitwise equal asserted,
     with both launches' tiles); Serial
     ADMM for 3 epochs (finite; the Table 3 ratio of serial to dense
     parallel step time, reported); the Adam baseline for 3 epochs
     (finite); and packed ELL with bf16 blocks for 2 epochs (finite, the
     ELL kernel launched on bf16 blocks holding half the f32 block bytes);
     3m. the paper's multi-agent form on the same graph: M = 3 communities
     over 3 logical shards of the card (the loopback transport runs each
     exchange round as row copies), packed, through the packed kernel
     (one launch over every shard's lanes per aggregation) for 3 epochs and
     with ``fused=True`` (the fused kernel at the four Z-update sites) for
     3, then 1 epoch each of overlap, the bf16 wire and a 1/3 batch: step
     ms, launches per step, wire bytes, profiled idle share, kernel vs
     plain route objectives after every run (<= 1e-5; fused <= 1e-4), one
     step against the one-shard trainer from the same state (tau/theta
     equal, <= 1e-4), fused vs unfused objectives (<= 1e-4), and the
     stacked packed and fused launches at the trainer's shapes against one
     launch per shard (bitwise) and their plain versions, then timed;
     3p. the agents as separate processes: the same M = 3 over 3 rank
     processes of a torch.distributed group on the card (gloo; each round's
     rows staged through pinned host buffers), one community a rank,
     packed, through the packed kernel for 3 epochs, then fused, overlap
     and the bf16 wire one epoch each: set-up s and step ms per rank, each
     rank's launches a step (packed 3; fused 2 + 4; overlap 3 per arrival
     group), the bytes sent a step against the plan's wire (equal), the
     transport's host ms with its staging copies apart, W equal on every
     rank after every step (by hash), the Lagrangian and residual finite,
     only rank 0 holding the full adjacency (for the metrics), rank 0's
     profiled idle share, and one step from each 3m trainer's state
     against the loopback's step (tau/theta equal, <= 1e-5 of max;
     bitwise reported); a rank that fails, hangs or exits nonzero fails
     the script;
  4. time the ELL and dense launches, their plain versions and the
     library composition (gather + einsum, masked einsum) at the trainer's
     shapes, beside the card's bound, with each launch's tile
     configuration;
  5. serve: train the same model at M = 16 for 2 epochs, build a
     CommunityServer with the serving launcher's defaults, drive the
     launcher's Zipf stream (2,048 requests in batches of 64) cached, then
     cold and fused-cold; check a 1,024-node probe against the dense
     forward pass (<= 1e-4 max), cached vs cold (bitwise), fused vs
     unfused (<= 1e-4 max) and, after a feature update, against a fresh
     server (bitwise); the packed kernel must launch in the cached and cold
     runs and the fused kernel in the fused run;
  6. time the packed and fused kernels, their plain versions and the
     gather + einsum (+ matmul) composition at the server's shapes, beside
     the card's bound, with the packed launch's tile configuration and the
     fused kernel's grid and cluster size;
  7. hold the SSD scan kernels against their plain version (f32 limit
     1e-4, bf16 one ulp, 2^-7 of max) at the Mamba-2 prefill shape (4 x
     4096, 64 heads of 64, d_state 128) in bf16 and f32, at 1 x 32768, at
     a ragged S = 1000 (chunk 8), at S = 100 < chunk, with 2 groups and
     at a mamba2-1.3b rank's 32 heads over 1 x 2 model ranks, 2 x 4096,
     the shape phase 17b launches it at (bf16: the three-pass tensor-core
     kernel, each case also beside the
     plain three-pass form with the kernel's bf16 roundings, reported;
     f32: the three-pass FFMA kernels, a fixed route by dtype, at 4 x
     4096 and 1 x 32768, each case also beside the plain three-pass form
     in f32, reported); and
     the flash attention kernels (bf16: the tensor-core kernel, limit
     2^-7; f32: the FFMA kernel, limit 1e-5) at qwen2-7b's, gemma-2b's and
     recurrentgemma-9b's attention shapes (causal; window 2048), one
     non-causal case, a ragged S = 3000, head_dim 80, f32 cases at
     qwen2-7b's and gemma-2b's heads (S 2048), one
     non-causal case with a window, and a deepseek-moe-16b rank's 8 heads
     over 1 x 2 model ranks (2 x 2048, Hq = Hkv = 8, head_dim 128: the
     shape phase 14b launches it at) and a deepseek-v3-671b rank's 64 MLA
     heads over 1 x 2 (2 x 2048, head_dim 192 with v's 128 padded with
     zeros: phase 17c's launch); and the context-parallel query rows of a
     rank at its query offset (phase 14's branch), among them a
     recurrentgemma-9b rank's over 1 x 2 (2 x 2,048 rows at offset 2,048
     of 4,096 keys, 16 heads over 1 KV head of 256, window 2,048, bf16
     and f32: the launch phase 18b makes);
  8. Mamba-2 1.3B at its published widths and depth (48 layers, d_model
     2048, bf16, random weights from a generator on the card): prefill
     4 x 4096 tokens through the kernel and through the plain path
     (last-token logits within LOGIT_TOL of max; exactly 48 ssd_scan
     launches per kernel forward, all 48 on the tensor-core route, 0 on the
     plain one), timed forwards
     (tokens/s, profiled idle share), 2 decode requests of 64 tokens
     (per-token latency), and decode against the kernel forward with the
     weights in f32 (probabilities within rtol 2e-2, atol 2e-3; that
     forward's 48 ssd_scan launches all on the FFMA route);
  9. time both kernels, their plain versions and (attention)
     scaled_dot_product_attention, beside the card's bound for the
     inputs' type: the SSD scan in bf16 (tensor cores) at 4 x 4096 and
     1 x 32768 with a profiled call's device time per pass, and in f32
     (FFMA, three passes) at both shapes, also per pass; each flash
     shape's route, blocks and TFLOP/s, f32 at qwen2-7b's and gemma-2b's
     heads (the
     SSD, flash and SDPA over windows of 10 calls, the SM clock printed
     beside);
  10. the attention families through the flash kernel, with random bf16
     weights from a generator on the card, each model freed before the
     next: qwen2-7b (28 layers, d_model 3584, 28 heads over 4, QKV bias,
     SwiGLU 18,944) and recurrentgemma-9b (38 layers, the local window of
     2,048) at their published widths and depth, prefill 2 x 4096 tokens,
     and deepseek-moe-16b (64 experts top-6 + 2 shared) at 2 x 2048:
     kernel route vs plain route (last-token logits within LOGIT_TOL of
     max; exactly 28 / 12 / 28 flash launches per kernel forward, all on
     the tensor-core route, 0 on the plain one; deepseek-moe-16b's bf16
     gap reported, since top-k routing is discontinuous, and held within
     1e-4 of max in f32 on its first 4 layers), tokens/s (median of 3),
     profiled idle share and device ms by kind, cached decode (2 x 64 /
     2 x 64 through the rolling cache / 2 x 32, per-token latency); for
     qwen2-7b also a batch of 32 against a 4,096-slot cache (ms a step,
     the cache's bytes) and decode against the kernel forward with the
     weights in f32 (the FFMA flash route; probabilities within rtol 2e-2,
     atol 2e-3); then gemma-2b, nemotron-4-15b, deepseek-v3-671b (MLA, v
     padded to the q/k head_dim), moonshot-v1-16b-a3b, internvl2-2b
     (vision prefix) and seamless-m4t-medium (non-causal encoder, decoder
     cross-attention) at their reduced configurations, 2 x 4096
     positions, kernel vs plain in f32 (1e-4 of max) and bf16 (LOGIT_TOL;
     the MoE models' bf16 gap reported), with their flash launch counts;
     each model's peak memory;
  11. language-model training, through the reference's plain route (no
     kernel has a backward pass, so none may launch in this phase):
     reduced f32 gemma-2b and deepseek-moe-16b on the card against the
     CPU from the same weights (a train_step with SGD at lr 1 and
     grad_accum 2, deltas within 1e-5 of max and the loss within 1e-5;
     one layerwise ADMM iteration, tau and theta equal, tensors within
     1e-4 of max); gemma-2b at its published widths and depth (18
     layers, d_model 2048, 8 heads over 1 KV head of 256, GeGLU 16,384,
     vocab 256,000, bf16, random weights) through launch/train.py's
     main: Adam, grad_accum 4, remat, 4 x 4096 tokens a step, 1 warm-up
     and 3 timed steps on pipeline batches (ms a step, tokens/s, the
     model-FLOPs share, peak memory), then 4 steps on one fixed batch
     (the loss after the last below the loss after the first) and a
     profiled step (idle share, device ms by kind and by matrix-product
     kernel); layerwise ADMM on the same model at 4 x 512 tokens, init
     and 3 iterations (init residual, ms an iteration, probes a line
     search, CE and residual finite, peak memory);
  12. the invariant linter (``repro_torch.analysis``) on the card, on the
     kernel route: launch/analyze.py's full config set over 4 loopback
     shards and both serving paths at the CLI's size, then the full-width
     trainers of phases 3 and 3m (packed ELL on one shard; packed and
     fused over 3 loopback shards), one recorded step each: every finding
     printed, zero error findings, every kernel launch on the CUDA route,
     each launch spec's shared memory within the card's per-block limit
     and equal to its CUDA layout query;
  13. the language models over a data x model mesh of rank processes
     sharing the card (gloo; NCCL refuses two ranks on one card), through
     the reference's plain route (no kernel launches on any rank): 13a, 2
     data ranks running Model.train_step_deferred (one bucketed reduction
     over data after the microbatches, summed in rank order) — reduced f32
     gemma-2b against one process's step on the whole batch (deltas within
     1e-5 of max, loss within 1e-5, the same bits on both ranks), then
     mamba2-1.3b at its published widths cut to 24 of its 48 layers
     (d_model 2048, bf16, Adam, grad_accum 2, remat) on 4 x 4096 tokens a
     step, 2
     sequences a rank, 1 warm-up and 2 timed steps (ms a step, tokens/s,
     peak GB a rank, bytes reduced a step and the host ms of the reduction
     and its staging, parameter hashes equal on both ranks after every
     step, losses finite); 13b, 2 x 2 ranks running
     LayerwiseADMMTrainer(mesh=...) (blocks over model, rows over data) —
     reduced f32 gemma-2b, one iteration from the one-process state after
     2 against one process (tau/theta equal, tensors within 1e-4 of max),
     then gemma-2b at full width on 4 x 512 tokens: init (a forward
     pipelined along model) and 2 iterations (ms an iteration, peak GB a
     rank, bytes summed over data and sent along model, probes a search,
     W hashes equal on the data ranks of each model rank, the composed CE
     below its initial value, the residual finite);
  14. the models' forward paths tensor-parallel over a data x model mesh
     of rank processes sharing the card (gloo), under
     sharding_hints(mesh, moe_a2a=True): each rank holds its slices by
     param_specs and its caches by cache_specs.  14a, 4 ranks as 2 x 2
     and 1 x 4: the reduced f32 deepseek-moe-16b (all-to-all MoE),
     qwen2-7b (heads branch on 2 x 2, context branch on 1 x 4) and
     gemma-2b (one KV head: context branch, the flash kernel at a query
     offset), the prefill forward through the flash kernel and 4 decode
     steps on the card against the same ranks on the CPU (logits within
     1e-4 of max), and decode against the mesh forward over the same
     tokens (probabilities within rtol 2e-2, atol 2e-3); 14b,
     deepseek-moe-16b at its published widths and depth (bf16, random
     weights from seed 0) over 1 x 2 ranks: the parameter bytes a rank
     (equal to its shards' bytes by param_specs, at most 55 % of one
     process's), prefill 2 x 2,048 through the flash kernel on each rank's
     8 heads (28 launches a rank a forward, counts set to 0 just before),
     median ms of 3 forwards after one warm-up and tokens/s, peak GB a
     rank, the bytes sent along model a forward (the all-to-all and the
     rest) and their host ms, the last-token logits gap to phase 10's
     one-process kernel forward (reported), then decode 2 x 8 (ms a token)
     and decode against the mesh forward over the same tokens (reported);
  15. the tensor-parallel training step (Model.train_step_deferred split
     over model: each rank holds its slices of the parameters by
     param_specs and of the Adam state, computes its share of the loss —
     the cross-entropy vocabulary-parallel on its block of the logits —
     and of its backward pass through the model-axis collectives, and
     updates its slices; one reduction over data after the microbatches)
     over rank processes sharing the card (gloo), through the plain route
     (no kernel may launch).  15a, 4 ranks as 2 x 2 and 1 x 4: the
     reduced f32 gemma-2b, qwen2-7b, deepseek-moe-16b and mamba2-1.3b,
     SGD at lr 1, grad_accum 1 and 2, on the card against the same ranks
     on the CPU from the same slices (new weights within 1e-4 of max
     |delta| beside one f32 spacing, the loss within 1e-5); 15b, gemma-2b
     at its published widths and depth (bf16, Adam, grad_accum 2, remat)
     over 1 x 2 ranks on 2 x 2,048 tokens (cut from train_4k), 1 warm-up
     and 2 timed steps on one fixed batch: step ms (slowest rank),
     parameter and Adam bytes a rank (equal to its shards' by the specs),
     peak GB a rank, the bytes sent along model a step and their host ms,
     the first step's loss against one process's train_step_deferred on
     the same weights and batch (run alone before the ranks start; within
     2^-7), the loss before the third step below the first's, and the
     leaves the same on every rank (norms) equal on both ranks by hash
     after every step;
  16. the meta-device dry run (launch/dryrun.py: one rank's step on meta
     tensors over a stand-in mesh, nothing allocated) held against what
     this run measured, each dry run in a process of its own, all started
     together: 16a, gemma-2b as phase 11 (Adam, grad_accum 4, remat, 4 x
     4,096, a 1 x 1 mesh): its arguments equal phase 11's parameter, Adam
     and batch bytes, its peak within 10 % of the card's peak over one
     fixed-batch train_step; 16b, phase 15b's setup on ranks 0 and 1 of
     1 x 2: the parameter bytes a rank and the bytes along model a step
     equal to each rank's, the peak within 10 % of each rank's; at most
     60 s;
  17. MLA (deepseek-v3-671b) and the Mamba-2 SSD mixer split over model
     on the rank's heads, over gloo ranks sharing the card under
     sharding_hints(mesh, moe_a2a=True).  17a, 4 ranks as 2 x 2 and
     1 x 4: the reduced f32 deepseek-v3-671b (the flash kernel on the
     rank's heads) and mamba2-1.3b (the SSD kernel on them), prefill and
     4 decode steps on the card against the same ranks on the CPU, as
     14a; 17b, mamba2-1.3b at its published widths cut to 8 of its 48
     layers (bf16) over 1 x 2: a 2 x 4,096 prefill through the SSD kernel
     (8 launches a rank, each on 32 of the 64 heads, counts set to 0
     just before) and
     one training step (the config's Adam, grad_accum 2); 17c,
     deepseek-v3-671b at its published widths cut to its three dense
     layers plus the multi-token-prediction layer (bf16, ~4.3 B
     parameters) over 1 x 2: a 2 x 2,048 prefill through the flash
     kernel (3 launches a rank, each on 64 of the 128 heads; the
     launchers count their launches by heads), 4 decode steps on the
     rank's slices of the latent cache and one SGD training
     step (grad_accum 2).  17b / 17c hold the parameter bytes a rank
     (its shards' by param_specs, at most 55 % of one process's), the
     logits within 5e-2 of max and the loss within 2^-7 of one process's
     on the card from the same seed and tokens; 17c's parameter bytes and
     bytes along model a training step equal to, and its peak within 10 %
     of, the dry run of the same step on each rank;
  18. the RG-LRU hybrid (recurrentgemma-9b), the vision prefix
     (internvl2-2b) and the encoder-decoder (seamless-m4t-medium) split
     over model, over gloo ranks sharing the card under
     sharding_hints(mesh, moe_a2a=True).  18a, 4 ranks as 2 x 2 and
     1 x 4: the three reduced f32 models, prefill through the flash
     kernel and 4 decode steps (the encoder-decoder's memory caches
     random) on the card against the same ranks on the CPU within 1e-5
     of max, the flash launches a rank and their heads printed; 18b,
     recurrentgemma-9b at its published widths cut to one (rglru, rglru,
     local attention) period and its two rglru_mlp tail blocks (bf16)
     over 1 x 2: a 2 x 4,096 prefill (the RG-LRU on each rank's channels,
     one flash launch a rank on all 16 heads of its 2,048 query rows,
     window 2,048), 4 decode steps and one SGD step (2 x 4,096); 18c,
     internvl2-2b at its published widths and depth over 1 x 2: a
     2 x (256 + 3,840) prefill (24 flash launches a rank, 8 heads each)
     and one SGD step on as many positions; 18d, seamless-m4t-medium at its published widths
     and depth over 1 x 2: 4,096 frames and 512 decoder tokens a row,
     prefill (12 encoder and 12 decoder flash launches a rank, 8 heads
     each) and 4 decode steps on random memory caches.  Each holds the
     parameter bytes a rank (its shards' by param_specs, at most 65 % of
     one process's: internvl2-2b's odd vocabulary stays whole), the logits
     within 5e-2 of max of one process's on the card from the same seed
     and inputs (bf16 partial sums over model, as phase 17's) and the
     loss within 1e-3; 18b / 18c's parameter bytes and bytes along model
     a training step equal to, and its peak within 5 % of, the dry run
     of the same step on each rank;
  19. print the kernels line, the card's name and power limit, and a last
     line {"ok": true, "device": {...}}.

With ``--four-cards`` (four cards of one host) it builds the kernels and
runs only phases 14c — 14b's full-width deepseek-moe-16b over NCCL ranks,
one a card, at 1 x 4 and at 2 x 2 (the FSDP leg live) — and 15c:
qwen2-7b at its published widths cut to 4 layers, 3 steps of one
process on the first card, then of 1 x 4 NCCL ranks from the same
weights and batch (each step's loss within 2^-7 of one process's: under
the config's Adam on random weights this model's loss rises at the third
step in one process too), and at its published depth over 1 x 4 (the
config's Adam, grad_accum 4, remat, 4 x 4,096 tokens, 1 warm-up and 2
timed steps; its training state, ~107 GB in one process, ~27 GB a
rank), then 16c: the dry run of 15c's four ranks held as in 16b.

Imports torch and the port (src/repro_torch) only.  Needs one CUDA device
and exits non-zero without one, or without the port beside it.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
TOL = 1e-5                     # max |kernel − plain| ≤ TOL · max |plain|
FUSED_TOL = 1e-4               # fused vs its reassociated plain version
EPOCHS = 3
SERVE_EPOCHS = 2
SERVE_PARTS = 16
KERNEL_SRC = "src/repro_torch/kernels/csrc/community_spmm_ell.cu"
FUSED_SRC = "src/repro_torch/kernels/csrc/community_spmm_ell_fused.cu"
REPLACES = "src/repro/kernels/community_spmm.py:359"
DENSE_REPLACES = "src/repro/kernels/community_spmm.py:273"
BF16_EPOCHS = 2
SHARDS = 3                     # phase 3m: M = 3 over 3 loopback shards
SHARD_MODE_EPOCHS = 1          # overlap, bf16 wire, batch 1/3
SHARD_TOL = 1e-4               # 3 shards vs 1 (the psum reassociated)
# phase 3p: M = 3 over 3 rank processes on the one card, (mode, trainer
# flags, epochs); each mode's step from the loopback's state within TOL
PROCESS_RUNS = (("unfused", {}, EPOCHS), ("fused", {"fused": True}, 1),
                ("overlap", {"overlap": True}, 1),
                ("bf16-wire", {"comm_bf16": True}, 1))
PROCESS_MODES = tuple(name for name, _, _ in PROCESS_RUNS)
PACKED_REPLACES = "src/repro/kernels/community_spmm.py:421"
ELL_DESIGN = ("FFMA from a cp.async ring of 32-row stages, one FFMA chain "
              "per output in slot and row order; tile chosen by "
              "community_spmm_ell_layout: 128x128 (8x8 per thread, one block "
              "per SM) where its grid fills the SMs twice, else 64x64 (8x4) "
              "or 64x32 (4x4), whichever loads the busiest SM less; 64x16 "
              "(4x1) where C <= 32")
FUSED_REPLACES = "src/repro/kernels/community_spmm.py:531"
FISTA_SRC = "src/repro_torch/kernels/csrc/fista_lanes.cu"
FISTA_REPLACES = ("no Pallas kernel: the reference's fista_lanes, an XLA "
                  "loop (src/repro/core/parallel.py:472)")
FISTA_DESIGN = ("one thread-block cluster a lane (ceil(n / 512) <= 8 "
                "blocks), the lane's rows resident in shared memory (in a "
                "global workspace past 8,896 rows at C = 10), one row a "
                "thread, f64 lane sums through distributed shared memory, "
                "every FISTA step and backtrack decided on the card")
DENSE_DESIGN = ("the ELL kernel's dense addressing (a compile-time flag): "
                "D = M slots, slot r live where mask[m, r] != 0, its Z rows "
                "at r * n_pad, no slot or count table read; the ELL "
                "kernel's cp.async ring, tiles and FFMA order, so dense = "
                "ELL bitwise")

SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"                # f32
SSD_TC_SRC = "src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu"
SSD_DESIGN = ("bf16 on the tensor cores (wgmma) in three kernels: chunk "
              "states in parallel (m64n64k16, both operands MN-major), the "
              "state passed across chunks in f32, each chunk's output per "
              "64-row tile (C.B^T and scores.x as flash's Q.K^T and P.V); "
              f"f32 in {SSD_SRC}, the same three passes on the CUDA cores: "
              "chunk states from a 2-stage cp.async ring of 32 rows (8 x 8 "
              "FFMA tiles a thread), the state passed in f32 (one template "
              "with bf16's, ssd_state.cuh), the output by 64-row tiles in "
              "order carrying the state entering each, so only the "
              "diagonal tiles' scores are formed, the next tile in flight")
# the SSD kernels by the names the profiler shows (the f32 pass 2 before
# the bf16 one: both are ssd_state_passing<T>)
SSD_KERNELS = {"ssd_f32_chunk_states": "ssd f32 pass 1 (chunk states)",
               "ssd_state_passing<float>": "ssd f32 pass 2 (state passing)",
               "ssd_f32_chunk_output": "ssd f32 pass 3 (output)",
               "ssd_chunk_states": "ssd pass 1 (chunk states)",
               "ssd_state_passing": "ssd pass 2 (state passing)",
               "ssd_chunk_output": "ssd pass 3 (output)"}
# the flash kernels by the names the profiler shows
FLASH_KERNELS = {"flash_wgmma_kernel": "flash_attention bf16 (tensor cores)",
                 "flash_ffma_kernel": "flash_attention f32 (FFMA)"}
FLASH_F32_DESIGN = ("register tiles on the CUDA cores: 128 query rows a "
                    "block (64 at hd 256), 8 x 8 scores and 8 x 8 outputs "
                    "a thread at hd 128, q.k^T from 16-byte loads along "
                    "the head_dim, P parked in shared memory for P.v, k "
                    "and v copied by cp.async behind the product that does "
                    "not read them, longest causal tiles first")
NAMED_KERNELS = {**SSD_KERNELS, **FLASH_KERNELS}
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"      # f32
FLASH_TC_SRC = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:67"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:90"
# kernel vs plain version, max |diff| <= limit · max |plain|: f32 flash
# 1e-5; f32 SSD 1e-4 (the chunk's cumsum is summed in another order and
# exp(cum_t − cum_u) turns its absolute error into a relative one); bf16
# outputs 2^-7, one bf16 ulp at the largest value (both sum in f32 and
# round once)
FLASH_F32_TOL = 1e-5
SSD_F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7
# Mamba-2 1.3B prefill, bf16, kernel path vs plain path: last-token logits
# within LOGIT_TOL · max |plain| (48 layers of bf16 rounding at different
# places: the plain path rounds C·Bᵀ to bf16, the kernel rounds y)
LOGIT_TOL = 5e-2
PREFILL = (4, 4096)            # batch × tokens, a cut of prefill_32k
SSD_LONG = (1, 32768)          # one sequence of prefill_32k
DECODE = (2, 64)               # batch × tokens of the decode requests
DECODE_RTOL, DECODE_ATOL = 2e-2, 2e-3   # tests/test_decode_consistency.py
# f32 decode vs f32 forward, logits within 1e-4 · max: the same f32
# arithmetic, the chunked scan against the token recurrence, summed in
# another order through 48 layers (with random weights the logits reach
# hundreds, so the softmax is nearly one-hot and the probability check alone
# would pass whatever the logits below the top one did)
DECODE_LOGIT_TOL = 1e-4

def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def clocks_line() -> str:
    """SM clock, power draw and temperature now, as nvidia-smi reads
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(out, ref) -> tuple[float, float]:
    """(max |out − ref|, that over max |ref|)."""
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err / scale if scale else err


def median_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call.  With ``inner`` > 1 the host enqueues while the card
    runs, so a sub-millisecond kernel is not charged the host's launch
    time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_busy_us(events) -> float:
    """Microseconds the card was busy: the union of the intervals of the
    device events (kernels, copies, fills) the profiler traced.  Host ops
    are left out: their device time is that of the kernels they launched,
    which appear as events of their own.  So are gloo's point-to-point
    waits (``gloo:recv``, ``gloo:send``), which the profiler files with
    the device events although no kernel runs in them."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("gloo:"))
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def work(blocks, idx, mask, rows, nbrs, c: int) -> tuple[float, float]:
    """(FLOPs, bytes) the ELL aggregation needs for these operands: only
    live slots, only rows inside the counts; each input read once (a Z row
    read by several slots counts once), the output written once."""
    import torch
    k, d, n = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    live = (mask != 0)
    r = torch.clamp(rows, max=n).double()[:, None]
    p = torch.clamp(nbrs, max=n).double() * live
    pairs = float((r * p).sum())
    z_rows = {}
    for slot in range(k * d):
        m_, d_ = divmod(slot, d)
        if live[m_, d_]:
            key = int(idx[m_, d_])
            z_rows[key] = max(z_rows.get(key, 0.0), float(p[m_, d_]))
    nbytes = (pairs * blocks.element_size() + sum(z_rows.values()) * c * 4
              + k * n * c * 4 + 4 * (3 * k * d + k))
    return 2.0 * c * pairs, nbytes


def layout_text(lay: dict) -> str:
    """One line of an ELL / packed launch's configuration
    (``community_spmm.operand_layout``)."""
    g = lay["grid"]
    return (f"{lay['tile']} tile {lay['bm']}x{lay['bn']} ({lay['tm']}x"
            f"{lay['tn']} per thread, {lay['threads']} threads), "
            f"{lay['stages']} stages, grid {g} = "
            f"{math.prod(g)} blocks, {lay['smem_bytes']} B shared, copies "
            f"A {lay['a_copy']} B / Z {lay['z_copy']} B")


def check_case(name, blocks, idx, mask, z, rows, nbrs, log) -> float:
    import torch

    from repro_torch.kernels import community_spmm, ref
    out = community_spmm.community_spmm_ell(blocks, idx, mask, z, rows, nbrs)
    torch.cuda.synchronize()
    want = ref.community_spmm_ell_einsum(blocks, idx, mask, z, rows, nbrs)
    err, rel = rel_err(out, want)
    ok = bool(torch.isfinite(out).all()) and rel <= TOL
    lay = community_spmm.operand_layout(blocks, z)
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel,
                "layout": lay})
    print(f"[2] {name}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"{'ok' if ok else 'FAIL'}; {layout_text(lay)}", flush=True)
    if not ok:
        fail(f"kernel disagrees with its plain version on {name}")
    return err


def packed_work(blocks, off, mask, rows, nbrs, plane_rows: int, c_in: int,
                c_out: "int | None" = None) -> tuple[float, float]:
    """(FLOPs, bytes) of the packed aggregation — and with ``c_out`` of the
    fused aggregation → GEMM — for these operands: only live slots, only
    rows inside the counts; each input read once (a plane row read by
    several slots counts once), the output written once."""
    import torch
    k, d, n = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    live = (mask != 0).cpu()
    r = torch.clamp(rows.cpu(), max=n).double()
    p = torch.clamp(nbrs.cpu(), max=n).double() * live
    pairs = float((r[:, None] * p).sum())
    read = torch.zeros(plane_rows, dtype=torch.bool)
    for m_, d_ in live.nonzero().tolist():
        start = int(off[m_, d_])
        read[start:start + int(p[m_, d_])] = True
    c_o = c_in if c_out is None else c_out
    flops = 2.0 * c_in * pairs
    nbytes = (pairs * blocks.element_size() + float(read.sum()) * c_in * 4
              + k * n * c_o * 4 + 4 * (3 * k * d + k))
    if c_out is not None:
        flops += 2.0 * float(r.sum()) * c_in * c_out
        nbytes += c_in * c_out * 4
    return flops, nbytes


def check_packed_case(name, blocks, off, mask, z, rows, nbrs, log,
                      self_mask=None) -> None:
    """The packed kernel (through ``ops``; with ``self_mask`` the halo
    split) against its plain version on the same CUDA tensors."""
    import torch

    from repro_torch.kernels import community_spmm, ops, ref
    if self_mask is None:
        out = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    else:
        out = ops.community_halo_spmm(blocks, off, mask, self_mask, z, rows,
                                      nbrs)
        mask = mask * (1.0 - self_mask)
        nbrs = (nbrs * (mask > 0)).to(torch.int32)
    torch.cuda.synchronize()
    want = ref.community_spmm_ell_packed_einsum(blocks, off, mask, z, rows,
                                                nbrs)
    err, rel = rel_err(out, want)
    ok = bool(torch.isfinite(out).all()) and rel <= TOL
    lay = community_spmm.operand_layout(blocks, z)
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel,
                "layout": lay})
    print(f"[2] packed {name}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"{'ok' if ok else 'FAIL'}; {layout_text(lay)}", flush=True)
    if not ok:
        fail(f"the packed kernel disagrees with its plain version on {name}")


def check_fused_case(name, blocks, off, mask, z, w, rows, nbrs, log) -> None:
    """The fused kernel against its reassociated plain version, against the
    packed kernel followed by torch.matmul, and with W = I bitwise against
    the packed kernel."""
    import torch

    from repro_torch.kernels import ops, ref
    out = ops.community_spmm_ell_fused(blocks, off, mask, z, w, rows, nbrs)
    agg = ops.community_spmm_ell_packed(blocks, off, mask, z, rows, nbrs)
    eye = torch.eye(z.shape[1], device=z.device)
    same = torch.equal(
        ops.community_spmm_ell_fused(blocks, off, mask, z, eye, rows, nbrs),
        agg)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref.community_spmm_ell_fused_einsum(
        blocks, off, mask, z, w, rows, nbrs))
    _, rel2 = rel_err(out, agg @ w)
    ok = (bool(torch.isfinite(out).all()) and rel <= FUSED_TOL
          and rel2 <= TOL and same)
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel,
                "rel_err_vs_packed_then_matmul": rel2,
                "identity_bitwise": same})
    print(f"[2] fused {name}: vs plain max_abs_err {err:.3e} rel {rel:.3e}; "
          f"vs packed+matmul rel {rel2:.3e}; W=I bitwise equal to packed: "
          f"{same} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the fused kernel disagrees on {name}")


def time_batches(server, stream, batch: int, first: int, warm: int,
                 timed: int) -> dict:
    """Serve batches first, first + 1, ... of the stream; host-clock the
    last ``timed`` (each ``serve`` ends in its response's host copy)."""
    import numpy as np
    times = []
    for i in range(first, first + warm + timed):
        tic = time.perf_counter()
        server.serve(stream[i * batch:(i + 1) * batch])
        if i >= first + warm:
            times.append(time.perf_counter() - tic)
    ms = np.asarray(times) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(times) * batch / sum(times), "batches": len(times)}


def counts() -> dict:
    """Every kernel's launch count."""
    from repro_torch.kernels import community_spmm
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssd_scan
    return {"ell": community_spmm.launches,
            "packed": community_spmm.packed_launches,
            "fused": community_spmm.fused_launches,
            "dense": community_spmm.dense_launches,
            "ssd": ssd_scan.ssd_launches,
            "ssd_tc": ssd_scan.ssd_tc_launches,
            "flash": flash.flash_launches,
            "flash_tc": flash.flash_tc_launches,
            "flash_offset": flash.flash_offset_launches}


def launch_heads() -> dict:
    """The flash and SSD launches by their number of heads, as the
    launchers count them (since the last ``reset_counts()``)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssd_scan
    return {"flash": dict(flash.flash_heads), "ssd": dict(ssd_scan.ssd_heads)}


def reset_counts(to: "dict | None" = None) -> None:
    """Set every launch count to 0 (and the launches by heads), or back
    to ``to`` (a ``counts()``)."""
    from repro_torch.kernels import community_spmm
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ssd_scan
    if to is None:
        flash.flash_heads.clear()
        ssd_scan.ssd_heads.clear()
    to = to or dict.fromkeys(counts(), 0)
    community_spmm.launches = to["ell"]
    community_spmm.packed_launches = to["packed"]
    community_spmm.fused_launches = to["fused"]
    community_spmm.dense_launches = to["dense"]
    ssd_scan.ssd_launches = to["ssd"]
    ssd_scan.ssd_tc_launches = to["ssd_tc"]
    flash.flash_launches = to["flash"]
    flash.flash_tc_launches = to["flash_tc"]
    flash.flash_offset_launches = to["flash_offset"]


def dense_work(mask, n: int, c: int) -> tuple[float, float]:
    """(FLOPs, bytes) the dense block-row aggregation needs for this (k, M)
    mask: only live blocks; each input read once (a Z block read by several
    lanes counts once), the output written once."""
    live = (mask != 0).cpu()
    k, m = live.shape
    n_live = float(live.sum())
    z_blocks = float(live.any(dim=0).sum())
    flops = 2.0 * n_live * n * n * c
    nbytes = (n_live * n * n * 4 + z_blocks * n * c * 4 + k * n * c * 4
              + k * m * 4)
    return flops, nbytes


def check_dense_case(name, a_row, z, mask, log) -> None:
    """The dense launch (through ``ops``: mask None, (M,) or (k, M); a_row
    3-D or 4-D) against its plain version on the same CUDA tensors."""
    import torch

    from repro_torch.kernels import community_spmm, ops, ref
    out = ops.community_spmm(a_row, z, mask)
    lay = community_spmm.operand_layout(
        a_row if a_row.dim() == 4 else a_row[None], z)
    torch.cuda.synchronize()
    if mask is None:
        mask = torch.ones(a_row.shape[-3], dtype=torch.int32, device=z.device)
    want = ref.community_spmm_ref(a_row, z, mask)
    err, rel = rel_err(out, want)
    ok = (bool(torch.isfinite(out).all()) and out.shape == want.shape
          and rel <= TOL)
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel,
                "layout": lay})
    print(f"[2] dense {name}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"{'ok' if ok else 'FAIL'}; {layout_text(lay)}", flush=True)
    if not ok:
        fail(f"the dense kernel disagrees with its plain version on {name}")


def check_finite_log(log, what: str) -> None:
    values = (log.lagrangian + log.residual + log.train_acc + log.test_acc
              + log.epoch_time_s)
    if not all(math.isfinite(v) for v in values):
        fail(f"a non-finite value in the {what} training log")


def print_log(tag: str, log) -> None:
    for j, i in enumerate(log.epoch):
        print(f"[{tag}] epoch {i}: step {1e3 * log.epoch_time_s[j]:.1f} ms, "
              f"lagrangian {log.lagrangian[j]:.6f}, residual "
              f"{log.residual[j]:.6e}, train {log.train_acc[j]:.4f}, test "
              f"{log.test_acc[j]:.4f}", flush=True)


def profiled(step) -> tuple[float, float, str, list]:
    """(wall µs, device-busy µs, idle share, traced events) of one profiled
    ``step()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    busy_us = device_busy_us(events)
    idle = (f"{1.0 - busy_us / wall_us:.4f}" if busy_us > 0 else
            "not measured (the profiler traced no device activity)")
    return wall_us, busy_us, idle, events


def profiled_idle(step) -> tuple[float, float, str]:
    """(wall µs, device-busy µs, idle share) of one profiled ``step()``."""
    return profiled(step)[:3]


def device_ms_by_kind(events, top: int = 4) -> dict:
    """Device milliseconds of the traced device events: each SSD scan
    kernel (the f32 FFMA kernel; the tensor-core route's three passes),
    each flash attention kernel, the cuBLAS matrix products, and the
    ``top`` largest others by name, with their count of events."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)

    def kind(name: str) -> str:
        low = name.lower()
        for key in NAMED_KERNELS:
            if key in low:
                return NAMED_KERNELS[key]
        if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            return "matrix products"
        return name[:60]
    kinds: dict = {}
    for name, (ms, n) in by_name.items():
        k_ms, k_n = kinds.get(kind(name), (0.0, 0))
        kinds[kind(name)] = (k_ms + ms, k_n + n)
    named = (*NAMED_KERNELS.values(), "matrix products")
    others = sorted((k for k in kinds if k not in named),
                    key=lambda k: -kinds[k][0])
    out = {k: kinds[k] for k in named if k in kinds}
    out.update({k: kinds[k] for k in others[:top]})
    rest = others[top:]
    out["rest"] = (sum(kinds[k][0] for k in rest),
                   sum(kinds[k][1] for k in rest))
    return {k: {"ms": round(ms, 3), "events": n} for k, (ms, n) in
            out.items()}


def dense_train_phase(cfg, admm, g, card: str, dev) -> dict:
    """Phase 3, dense: Parallel ADMM on the dense block tensor through the
    dense launch; then the dense launch against the strided ELL launch on
    the same layout's compressed view."""
    import torch

    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.kernels import community_spmm
    t0 = time.perf_counter()
    tr = ParallelADMMTrainer(cfg, admm, g, num_parts=3, seed=0,
                             config=TrainerConfig.dense(use_kernel=True),
                             device=dev)
    torch.cuda.synchronize()
    lay = tr.layout
    print(f"[3d] set-up {time.perf_counter() - t0:.1f} s: dense a_blocks "
          f"{tuple(tr.data.a_blocks.shape)} = "
          f"{tr.data.adjacency_nbytes / 1e6:.1f} MB, live blocks "
          f"{int(tr.data.neighbor_mask.sum())}/{lay.num_parts ** 2}, "
          f"transport {tr.transport}", flush=True)
    reset_counts()
    log = tr.train(EPOCHS)
    launches = community_spmm.dense_launches
    print_log("3d", log)
    check_finite_log(log, "dense")
    st = tr.state
    for t in st.weights + st.zs + (st.u,) + st.taus + st.thetas:
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite value in the dense trainer state")
    if launches == 0:
        fail("the dense training run never launched the dense kernel")
    worst = objective_gap(tr)
    print(f"[3d] trained state: objectives and gradients, kernel vs plain "
          f"path: max rel diff {worst:.3e}", flush=True)
    if not worst <= TOL:
        fail(f"dense objectives differ between paths by {worst:.3e}")
    reset_counts()
    tr.step()
    per_step = community_spmm.dense_launches
    print(f"[3d] dense kernel launches: {launches} in {EPOCHS} epochs "
          f"({launches / EPOCHS:g} per epoch), {per_step} per step "
          f"[{card}]", flush=True)
    wall_us, busy_us, idle = profiled_idle(tr.step)
    print(f"[3d] profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, device idle share {idle} [{card}]",
          flush=True)

    # the dense launch against the strided ELL launch on the compressed
    # view of the same layout: one FFMA chain per output over the live
    # blocks in order
    csr = lay.compress()
    rows, nbrs = csr.ell_row_counts()

    def dv(x):
        return torch.as_tensor(x, device=dev)
    ell = [dv(csr.ell_blocks), dv(csr.ell_indices).to(torch.int32),
           dv((csr.ell_mask != 0).astype("int32")), None, dv(rows),
           dv(nbrs)]
    nbr = tr.data.neighbor_mask.to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((lay.num_parts, lay.n_pad, 1000), generator=gen,
                    device=dev)
    before = counts()
    out_d = community_spmm.community_spmm(tr.data.a_blocks, z, nbr)
    ell[3] = z
    out_e = community_spmm.community_spmm_ell(*ell)
    torch.cuda.synchronize()
    reset_counts(before)
    bitwise = torch.equal(out_d, out_e)
    err, rel = rel_err(out_d, out_e)
    print(f"[3d] dense launch vs ELL launch on the M=3 layout (max_deg "
          f"{csr.max_deg}, row counts {rows.tolist()}), C=1000: bitwise "
          f"equal {bitwise}, max_abs_err {err:.3e} rel {rel:.3e}; dense "
          f"{layout_text(community_spmm.operand_layout(tr.data.a_blocks, z))}"
          f"; ELL {layout_text(community_spmm.operand_layout(ell[0], z))}",
          flush=True)
    if not bitwise:
        fail(f"the dense and ELL launches are not bitwise equal on the M=3 "
             f"layout (rel {rel:.3e}): their FFMA order differs")
    steps = log.epoch_time_s
    out = {"launches": launches, "per_step": per_step,
           "steps_ms": [1e3 * t for t in steps],
           "median_step_ms": 1e3 * statistics.median(steps),
           "idle": idle, "objective_gap": worst,
           "vs_ell_bitwise": bitwise, "vs_ell_rel_err": rel}
    del tr, ell, z, out_d, out_e
    torch.cuda.empty_cache()
    return out


def serial_phase(cfg, admm, g, card: str, dev, dense_step_ms: float) -> dict:
    """Phase 3, Serial ADMM and the Adam baseline on the dense Ã."""
    import torch

    from repro_torch.core.serial import BaselineTrainer, SerialADMMTrainer
    t0 = time.perf_counter()
    tr = SerialADMMTrainer(cfg, admm, g, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[3s] set-up {time.perf_counter() - t0:.1f} s: dense Ã "
          f"{tuple(tr.a_tilde.shape)} = "
          f"{tr.a_tilde.numel() * 4 / 1e6:.1f} MB", flush=True)
    log = tr.train(EPOCHS)
    print_log("3s", log)
    check_finite_log(log, "serial")
    st = tr.state
    for t in st.weights + st.zs + (st.u,):
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite value in the serial trainer state")
    serial_ms = 1e3 * statistics.median(log.epoch_time_s)
    print(f"[3s] Table 3 ratio, serial step / dense parallel step: "
          f"{serial_ms:.1f} / {dense_step_ms:.1f} ms = "
          f"{serial_ms / dense_step_ms:.3f} (reported, not asserted: on one "
          f"card the 3 community lanes share each kernel, so this compares "
          f"work per step, not the paper's 3-agent parallelism) [{card}]",
          flush=True)
    del tr
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base = BaselineTrainer(cfg, g, "adam", 1e-3, seed=0, device=dev)
    blog = base.train(EPOCHS)
    for i in blog.epoch:
        print(f"[3b] adam epoch {i}: step {1e3 * blog.epoch_time_s[i]:.1f} "
              f"ms, loss {blog.lagrangian[i]:.6f}, train "
              f"{blog.train_acc[i]:.4f}, test {blog.test_acc[i]:.4f}",
              flush=True)
    check_finite_log(blog, "baseline")
    for t in base.weights:
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite weight after the baseline training")
    print(f"[3b] baseline phase {time.perf_counter() - t0:.1f} s", flush=True)
    del base
    torch.cuda.empty_cache()
    return {"steps_ms": [1e3 * t for t in log.epoch_time_s],
            "median_step_ms": serial_ms,
            "lagrangian": log.lagrangian,
            "table3_ratio": serial_ms / dense_step_ms,
            "baseline_steps_ms": [1e3 * t for t in blog.epoch_time_s]}


def bf16_phase(cfg, admm, g, card: str, dev, f32_blocks: int,
               f32_resident: int) -> dict:
    """Phase 3, bf16 ELL blocks: the packed trainer through the bf16 entry
    of the ELL kernel."""
    import torch

    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.kernels import community_spmm
    tr = ParallelADMMTrainer(cfg, admm, g, num_parts=3, seed=0,
                             config=TrainerConfig.packed(use_kernel=True,
                                                         adjacency_bf16=True),
                             device=dev)
    blocks = tr.data.ell_blocks
    if blocks.dtype != torch.bfloat16:
        fail("the adjacency_bf16 trainer holds no bf16 blocks")
    reset_counts()
    log = tr.train(BF16_EPOCHS)
    launches = community_spmm.launches
    print_log("3h", log)
    check_finite_log(log, "bf16")
    if launches == 0:
        fail("the bf16 training run never launched the ELL kernel")
    b16 = blocks.numel() * blocks.element_size()
    resident = tr.data.adjacency_nbytes
    print(f"[3h] bf16 ELL blocks: {launches} ELL launches on bf16 blocks in "
          f"{BF16_EPOCHS} epochs; block bytes {b16} vs f32 {f32_blocks} "
          f"(ratio {b16 / f32_blocks:.4f}); resident adjacency {resident} vs "
          f"f32 {f32_resident} B [{card}]", flush=True)
    if 2 * b16 != f32_blocks:
        fail("the bf16 ELL blocks do not hold half the f32 block bytes")
    out = {"launches": launches,
           "steps_ms": [1e3 * t for t in log.epoch_time_s],
           "block_bytes": b16, "f32_block_bytes": f32_blocks,
           "resident_bytes": resident, "f32_resident_bytes": f32_resident}
    del tr, blocks
    torch.cuda.empty_cache()
    return out


def trained(tr, tag: str, epochs: int):
    """Train ``epochs`` epochs with every launch count set to 0 just before
    and read just after; then one more step's counts.  Returns (log, the
    run's counts, one step's counts)."""
    import torch
    reset_counts()
    log = tr.train(epochs)
    run = counts()
    print_log(tag, log)
    check_finite_log(log, tag)
    st = tr.state
    for t in st.weights + st.zs + (st.u,) + st.taus + st.thetas:
        if not bool(torch.isfinite(t).all()):
            fail(f"a non-finite value in the {tag} trainer state")
    reset_counts()
    tr.step()
    return log, run, counts()


def objectives_gap(a: dict, b: dict) -> float:
    """Largest relative difference between two ``objectives()`` results."""
    worst = 0.0
    for kind in ("w", "z"):
        for (va, ga), (vb, gb) in zip(a[kind], b[kind]):
            for x, y in ((va, vb), (ga, gb)):
                worst = max(worst, rel_err(x, y)[1])
    return worst


def launch_text(c: dict) -> str:
    return (f"ELL {c['ell']}, packed {c['packed']}, fused {c['fused']}")


def state_arrays(st) -> list:
    """A trainer state's leaves as host arrays, in ``ParallelState``
    order."""
    return [t.detach().cpu().numpy() for t in
            st.weights + st.zs + (st.u,) + st.taus + st.thetas]


def save_loopback(tr, saved: dict, name: str) -> None:
    """Keep the loopback trainer's state and its next state from there (on
    the host, in ``saved["dir"]``) for phase 3p's ranks to step from."""
    import numpy as np
    path = pathlib.Path(saved["dir"]) / f"loopback-{name}.npz"
    np.savez(path, *state_arrays(tr.state))
    saved[name] = {"path": str(path), "next": state_arrays(tr.next_state()),
                   "layers": tr.cfg.num_layers}


def multishard_phase(cfg, admm, g, card: str, dev, peak_flops: float,
                     peak_bw: float, saved: dict) -> dict:
    """Phase 3m: the paper's multi-agent Parallel ADMM, M = 3 communities
    over 3 loopback shards of the card on the packed wire: unfused and
    fused training, one epoch each of overlap, the bf16 wire and a 1/3
    batch; a step against the one-shard trainer; the stacked launches
    against per-shard launches and against their plain versions; and the
    packed and fused kernels timed at the trainer's shapes.  Each trained
    state of the unfused, fused, overlap and bf16-wire runs and the step
    from it go to ``saved`` (phase 3p)."""
    import torch

    from repro_torch.core import graph
    from repro_torch.core.parallel import (ParallelADMMTrainer,
                                           ParallelState, TrainerConfig)
    from repro_torch.kernels import community_spmm, ref
    part = graph.partition_graph(g.num_nodes, g.edges, 3, seed=0,
                                 method="bfs_kl")

    def build(n_shards=SHARDS, **kw):
        t0 = time.perf_counter()
        tr = ParallelADMMTrainer(
            cfg, admm, g, num_parts=3, seed=0, part=part, device=dev,
            n_shards=n_shards,
            config=TrainerConfig.packed(use_kernel=True,
                                        partitioner="bfs_kl", **kw))
        torch.cuda.synchronize()
        return tr, time.perf_counter() - t0

    out: dict = {}
    tr, setup = build()
    plan, cs = tr._plan, tr.comm_stats
    print(f"[3m] set-up {setup:.1f} s: M=3 over {tr.n_shards} loopback "
          f"shards, row counts {tr.layout.eff_row_counts().tolist()}, "
          f"{plan.num_rounds} exchange rounds, r_pad {plan.r_pad}, receive "
          f"planes {tr.n_shards} x {plan.recv_plane_rows} rows, state planes "
          f"{tr.n_shards} x {tr.packed_layout.plane_rows} rows; wire "
          f"{cs['wire_bytes']} B per step (all-gather {cs['full_bytes']} "
          f"B), overlap model efficiency "
          f"{cs['overlap']['overlap_efficiency']:.4f}", flush=True)
    log, run, per = trained(tr, "3m", EPOCHS)
    save_loopback(tr, saved, "unfused")
    if run["packed"] == 0:
        fail("the 3-shard packed training run never launched the packed "
             "kernel")
    if run["fused"] != 0:
        fail("the unfused 3-shard run launched the fused kernel")
    wall_us, busy_us, idle, events = profiled(tr.step)
    kinds = device_ms_by_kind(events, top=6)
    print(f"[3m] unfused: launches in {EPOCHS} epochs {launch_text(run)}; "
          f"per step {launch_text(per)}; wire {cs['wire_bytes']} B per "
          f"step; profiled step wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, device idle share {idle}; device ms by "
          f"kind {json.dumps(kinds)} [{card}]", flush=True)
    worst = objective_gap(tr)
    print(f"[3m] trained state: objectives and gradients, kernel vs plain "
          f"route on the card: max rel diff {worst:.3e}", flush=True)
    if not worst <= TOL:
        fail(f"3-shard objectives differ between routes by {worst:.3e}")
    out["unfused"] = {"steps_ms": [1e3 * t for t in log.epoch_time_s],
                      "launches": run, "per_step": per, "idle": idle,
                      "busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
                      "by_kind": kinds, "objective_gap": worst,
                      "wire_bytes": cs["wire_bytes"]}

    # the stacked launches at the trainer's shapes: against one launch per
    # shard (bitwise) and their plain versions; then their times
    body, batch = tr._body, tr._full
    rpr, k = plan.recv_plane_rows, body.k
    csr = tr.layout.compress()
    local = torch.as_tensor(plan.localized_offsets(
        csr.ell_indices, csr.ell_mask), dtype=torch.int32, device=dev)
    ops_ = (body.ell_rows, body.offsets, body.ell_live)
    counts_ = (body.ell_rcnt, body.ell_ncnt)
    inputs = [(body.z0, tr.state.weights[0]),
              (body.from_plane(tr.state.zs[0]), tr.state.weights[1])]
    stacked, timed = [], {}
    before = counts()
    for x, w in inputs:
        c_in, c_out = w.shape
        plane = body.gather(x, batch)
        p_out = community_spmm.community_spmm_ell_packed(*ops_, plane,
                                                         *counts_)
        f_out = community_spmm.community_spmm_ell_fused(*ops_, plane, w,
                                                        *counts_)
        per_p, per_f = [], []
        for s in range(tr.n_shards):
            lanes = slice(s * k, (s + 1) * k)
            args = (body.ell_rows[lanes], local[lanes].contiguous(),
                    body.ell_live[lanes], plane[s * rpr:(s + 1) * rpr])
            cnt = (body.ell_rcnt[lanes], body.ell_ncnt[lanes])
            per_p.append(community_spmm.community_spmm_ell_packed(*args,
                                                                  *cnt))
            per_f.append(community_spmm.community_spmm_ell_fused(
                *args, w, *cnt))
        torch.cuda.synchronize()
        same_p = torch.equal(p_out, torch.cat(per_p))
        same_f = torch.equal(f_out, torch.cat(per_f))
        err_p, rel_p = rel_err(p_out, ref.community_spmm_ell_packed_einsum(
            *ops_, plane, *counts_))
        err_f, rel_f = rel_err(f_out, ref.community_spmm_ell_fused_einsum(
            *ops_, plane, w, *counts_))
        _, rel_pm = rel_err(f_out, p_out @ w)
        ok = (same_p and same_f and rel_p <= TOL and rel_f <= FUSED_TOL
              and rel_pm <= TOL)
        rec = {"c_in": c_in, "c_out": c_out, "plane_rows": plane.shape[0],
               "packed_bitwise_per_shard": same_p,
               "fused_bitwise_per_shard": same_f,
               "packed_max_abs_err": err_p, "packed_max_rel_err": rel_p,
               "fused_max_abs_err": err_f, "fused_max_rel_err": rel_f,
               "fused_rel_err_vs_packed_then_matmul": rel_pm}
        stacked.append(rec)
        print(f"[3m] stacked launch, {tr.n_shards} shards' lanes, plane "
              f"{plane.shape[0]} rows, {c_in}->{c_out}: packed = per-shard "
              f"launches bitwise {same_p}, fused = per-shard bitwise "
              f"{same_f}; packed vs plain max_abs_err {err_p:.3e} rel "
              f"{rel_p:.3e}, fused vs plain rel {rel_f:.3e}, fused vs "
              f"packed+matmul rel {rel_pm:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"a stacked launch disagrees at {c_in}->{c_out}")
        reset_counts(before)
        t_p = time_packed(*ops_, *counts_, plane, peak_flops, peak_bw)
        t_f = time_packed(*ops_, *counts_, plane, peak_flops, peak_bw, w=w)
        grid = community_spmm.fused_grid(body.m, body.ell_rows.shape[2],
                                         c_in)
        t_f.update(grid=grid, cluster=grid[0], blocks=math.prod(grid))
        timed[c_in] = {"packed": t_p, "fused": t_f}
        for name, t in (("packed", t_p), ("fused", t_f)):
            print(f"[3m] {name} kernel at the trainer's shape k={body.m} "
                  f"D={body.ell_rows.shape[1]} n_pad="
                  f"{body.ell_rows.shape[2]} plane {plane.shape[0]} "
                  f"{c_in}->{c_out if name == 'fused' else c_in}: kernel "
                  f"{t['ms']:.3f} ms, plain version {t['plain_ms']:.3f} ms, "
                  f"library {t['library_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.3f} ms ({t['bound_by']}; "
                  f"{t['gflop']:.2f} GFLOP, {t['mbytes']:.1f} MB) [{card}]",
                  flush=True)
        del plane, p_out, f_out, per_p, per_f
    reset_counts(before)
    out["stacked"], out["timed"] = stacked, timed

    # one step of the 3-shard trainer against the one-shard packed trainer
    t1, _ = build(n_shards=1)
    dl3, dl1 = tr.packed_layout, t1.packed_layout

    def move(p):                      # 3-shard planes -> the 1-shard plane
        blk = dl3.unpack_state(p.cpu().numpy())
        return torch.as_tensor(dl1.pack_state(blk), device=dev)
    st = tr.state
    t1.state = ParallelState(st.weights, tuple(move(z) for z in st.zs),
                             move(st.u), st.taus, st.thetas)
    obj_gap = objectives_gap(tr.objectives(), t1.objectives())
    s3, s1 = tr.next_state(), t1.next_state()
    same = all(torch.equal(a, b) for a, b in
               zip(s3.taus + s3.thetas, s1.taus + s1.thetas))
    worst = max(rel_err(a, b)[1] for a, b in
                zip(s3.weights + tuple(tr._unfold(z) for z in s3.zs)
                    + (tr._unfold(s3.u),),
                    s1.weights + tuple(t1._unfold(z) for z in s1.zs)
                    + (t1._unfold(s1.u),)))
    print(f"[3m] one step, 3 shards vs 1 shard from the trained state: "
          f"tau/theta equal {same}, W/Z/U max rel diff {worst:.3e} (limit "
          f"{SHARD_TOL}); objectives and gradients max rel diff "
          f"{obj_gap:.3e}", flush=True)
    if not (same and worst <= SHARD_TOL and obj_gap <= SHARD_TOL):
        fail("the 3-shard step disagrees with the one-shard step")
    out["vs_one_shard"] = {"tau_theta_equal": same, "max_rel_err": worst,
                           "objectives_rel_err": obj_gap}
    del t1, s3, s1
    torch.cuda.empty_cache()

    # fused: the four Z-update sites through the fused kernel
    tf, setup = build(fused=True)
    log_f, run_f, per_f = trained(tf, "3m-fused", EPOCHS)
    save_loopback(tf, saved, "fused")
    if run_f["fused"] == 0:
        fail("the fused 3-shard training run never launched the fused "
             "kernel")
    wall_us, busy_us, idle_f, events = profiled(tf.step)
    kinds_f = device_ms_by_kind(events, top=6)
    worst_f = objective_gap(tf)
    print(f"[3m] fused, trained state: objectives and gradients, kernel vs "
          f"plain route (the reassociated A·(Z·W)) on the card: max rel "
          f"diff {worst_f:.3e} (limit {FUSED_TOL})", flush=True)
    if not worst_f <= FUSED_TOL:
        fail(f"fused objectives differ between routes by {worst_f:.3e}")
    tf.state = tr.state
    gap = objectives_gap(tf.objectives(), tr.objectives())
    print(f"[3m] fused: set-up {setup:.1f} s; launches in {EPOCHS} epochs "
          f"{launch_text(run_f)}; per step {launch_text(per_f)}; profiled "
          f"step wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, device idle share {idle_f}; device ms "
          f"by kind {json.dumps(kinds_f)}; fused vs "
          f"unfused objectives and gradients at one state: max rel diff "
          f"{gap:.3e} (limit {FUSED_TOL}) [{card}]", flush=True)
    if not gap <= FUSED_TOL:
        fail(f"fused and unfused objectives differ by {gap:.3e}")
    out["fused"] = {"steps_ms": [1e3 * t for t in log_f.epoch_time_s],
                    "launches": run_f, "per_step": per_f, "idle": idle_f,
                    "busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
                    "by_kind": kinds_f, "objective_gap": worst_f,
                    "vs_unfused_rel_err": gap}
    del tf, tr
    torch.cuda.empty_cache()

    for name, kw in (("overlap", {"overlap": True}),
                     ("bf16-wire", {"comm_bf16": True}),
                     ("batch-1/3", {"batch_fraction": 1 / 3})):
        tm, setup = build(**kw)
        log_m, run_m, per_m = trained(tm, f"3m-{name}", SHARD_MODE_EPOCHS)
        if name in PROCESS_MODES:
            save_loopback(tm, saved, name)
        if run_m["packed"] == 0:
            fail(f"the {name} run never launched the packed kernel")
        cs = tm.comm_stats
        mb = cs["minibatch"]
        wire = mb["sampled_wire_bytes"] if mb["enabled"] else cs["wire_bytes"]
        worst_m = objective_gap(tm)
        print(f"[3m] {name}: set-up {setup:.1f} s; launches in "
              f"{SHARD_MODE_EPOCHS} epoch {launch_text(run_m)}; per step "
              f"{launch_text(per_m)}; wire {wire} B per step; overlap "
              f"groups {cs['overlap']['num_groups']} (enabled "
              f"{cs['overlap']['enabled']}); trained state: objectives and "
              f"gradients, kernel vs plain route: max rel diff "
              f"{worst_m:.3e} (limit {TOL}) [{card}]", flush=True)
        if not worst_m <= TOL:
            fail(f"{name} objectives differ between routes by "
                 f"{worst_m:.3e}")
        out[name] = {"steps_ms": [1e3 * t for t in log_m.epoch_time_s],
                     "launches": run_m, "per_step": per_m,
                     "wire_bytes": wire, "objective_gap": worst_m}
        del tm
        torch.cuda.empty_cache()
    print(f"[3m] summary {json.dumps(out)}", flush=True)
    return out


def process_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 3p, one rank: its trainer of each mode over the process
    transport (gloo on the one card), trained, counted, profiled, and one
    step from the loopback trainer's state; its record to
    ``spec["dir"]/rank{rank}.json`` and its next state's part to
    ``rank{rank}-{mode}.npz``."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.configs import gcn_paper
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import graph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.launch import mesh as mesh_lib
    t_start = time.perf_counter()
    mesh = mesh_lib.init_process_mesh(rank, SHARDS, "gloo", store,
                                      timeout=120)
    dev = mesh.device
    try:
        cfg, admm = gcn_paper.config("amazon_computers")
        g = graph.synthetic_sbm("amazon_computers", seed=0)
        part = graph.partition_graph(g.num_nodes, g.edges, 3, seed=0,
                                     method="bfs_kl")
        out = {"device": str(dev), "ready_s": time.perf_counter() - t_start}

        def w_hash(tr):
            h = hashlib.sha256()
            for w in tr.state.weights:
                h.update(w.detach().cpu().numpy().tobytes())
            return h.hexdigest()

        for name, kw, epochs in PROCESS_RUNS:
            t0 = time.perf_counter()
            tr = ParallelADMMTrainer(
                cfg, admm, g, num_parts=3, seed=0, part=part, mesh=mesh,
                config=TrainerConfig.packed(use_kernel=True,
                                            partitioner="bfs_kl", **kw))
            torch.cuda.synchronize(dev)
            rec = {"setup_s": time.perf_counter() - t0, "steps_ms": [],
                   "w_hashes": [], "metrics": [], "per_step": [],
                   "sent_bytes": [], "transport_ms": [], "staging_ms": []}
            reset_counts()
            for _ in range(epochs):
                before = counts()
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                tr.step()
                torch.cuda.synchronize(dev)
                rec["steps_ms"].append(1e3 * (time.perf_counter() - t1))
                after = counts()
                rec["per_step"].append({k: after[k] - before[k]
                                        for k in after})
                cs = tr.comm_stats
                rec["sent_bytes"].append(cs["sent_bytes"])
                rec["transport_ms"].append(1e3 * cs["transport_s"])
                rec["staging_ms"].append(1e3 * cs["staging_s"])
                rec["w_hashes"].append(w_hash(tr))
                rec["metrics"].append(tr.epoch_metrics())
            rec["launches"] = counts()
            rec["wire_bytes"] = tr.comm_stats["wire_bytes"]
            rec["groups"] = tr.comm_stats["overlap"]["num_groups"] \
                if tr.comm_stats["overlap"]["enabled"] else 1
            rec["resident_adjacency_bytes"] = int(tr.data.adjacency_nbytes)
            rec["holds_full_adjacency"] = tr._full_data is not None
            if name == "unfused":
                if rank == 0:
                    wall_us, busy_us, idle, events = profiled(tr.step)
                    rec["profiled"] = {
                        "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
                        "idle": idle,
                        "by_kind": device_ms_by_kind(events, top=6)}
                else:
                    tr.step()
            # one step from the loopback trainer's state of this mode
            src = spec["loopback"][name]
            with np.load(src["path"]) as data:
                leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
            n = src["layers"]
            tr.state = state_from_numpy(
                leaves[:n], leaves[n:2 * n], leaves[2 * n],
                leaves[2 * n + 1:3 * n + 1], leaves[3 * n + 1:],
                device=dev, lanes=tr._lanes)
            np.savez(pathlib.Path(spec["dir"]) / f"rank{rank}-{name}.npz",
                     *state_arrays(tr.next_state()))
            out[name] = rec
            del tr
            torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        (pathlib.Path(spec["dir"]) / f"rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        mesh_lib.destroy(mesh)


def process_phase(card: str, saved: dict) -> dict:
    """Phase 3p: the paper's agents as separate processes — 3 ranks on the
    one card (gloo, rows staged through the host), each hosting one of the
    M = 3 communities at full width, trained through the packed kernel (3
    epochs; then fused, overlap and the bf16 wire one epoch each) and
    stepped from the loopback trainer's state of phase 3m."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_lib
    spec = {"dir": saved["dir"], "loopback": {
        name: {"path": saved[name]["path"], "layers": saved[name]["layers"]}
        for name, _, _ in PROCESS_RUNS}}
    t0 = time.perf_counter()
    mesh_lib.run_ranks(process_rank, SHARDS, (spec,), timeout=900)
    wall = time.perf_counter() - t0
    ranks = [json.loads((pathlib.Path(saved["dir"]) / f"rank{r}.json")
                        .read_text()) for r in range(SHARDS)]
    print(f"[3p] {SHARDS} ranks (gloo, one card) in {wall:.1f} s: devices "
          f"{[r['device'] for r in ranks]}, ready (group joined) "
          f"{[round(r['ready_s'], 1) for r in ranks]} s, peak "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB [{card}]",
          flush=True)
    out: dict = {"wall_s": wall}
    want_launches = {"unfused": {"packed": 3, "fused": 0},
                     "fused": {"packed": 2, "fused": 4}}
    for name, _, epochs in PROCESS_RUNS:
        recs = [r[name] for r in ranks]
        head = recs[0]
        print(f"[3p] {name}: set-up {[round(r['setup_s'], 1) for r in recs]} "
              f"s by rank; step ms by epoch, rank 0 "
              f"{[round(t, 1) for t in head['steps_ms']]}, every rank "
              f"{[[round(t, 1) for t in r['steps_ms']] for r in recs]}",
              flush=True)
        for e in range(epochs):
            tr_acc, te_acc, lag, res = head["metrics"][e]
            print(f"[3p] {name} epoch {e}: lagrangian {lag:.6f}, residual "
                  f"{res:.6e}, train {tr_acc:.4f}, test {te_acc:.4f}; sent "
                  f"{head['sent_bytes'][e]} B (plan {head['wire_bytes']} B); "
                  f"transport ms by rank "
                  f"{[round(r['transport_ms'][e], 1) for r in recs]}, of it "
                  f"host staging "
                  f"{[round(r['staging_ms'][e], 1) for r in recs]}",
                  flush=True)
            if not (math.isfinite(lag) and math.isfinite(res)):
                fail(f"3p {name}: a non-finite Lagrangian or residual")
            if any(r["sent_bytes"][e] != head["wire_bytes"] for r in recs):
                fail(f"3p {name}: the ranks sent {head['sent_bytes'][e]} B, "
                     f"the plan wires {head['wire_bytes']} B")
            if any(r["w_hashes"][e] != head["w_hashes"][e] for r in recs):
                fail(f"3p {name}: W differs between ranks after step {e}")
            if any(r["metrics"][e] != head["metrics"][e] for r in recs):
                fail(f"3p {name}: the ranks report different metrics")
        per_step = [r["per_step"] for r in recs]
        print(f"[3p] {name}: launches a step by rank (packed, fused) "
              f"{[[(c['packed'], c['fused']) for c in p] for p in per_step]}"
              f"; W equal on every rank after every step (sha256 "
              f"{head['w_hashes'][-1][:16]}); resident adjacency by rank "
              f"{[r['resident_adjacency_bytes'] for r in recs]} B, full "
              f"adjacency held {[r['holds_full_adjacency'] for r in recs]}",
              flush=True)
        # overlap splits each aggregation by arrival group
        want = want_launches.get(name, {"packed": 3 * head["groups"],
                                        "fused": 0})
        for p in per_step:
            for c in p:
                if c["packed"] != want["packed"] or \
                        c["fused"] != want["fused"]:
                    fail(f"3p {name}: a rank's step launched packed "
                         f"{c['packed']}, fused {c['fused']} (want "
                         f"{want['packed']}, {want['fused']})")
        if any(r["holds_full_adjacency"] for r in recs[1:]):
            fail("3p: a rank other than 0 holds the full adjacency")
        # one step from the loopback's state: each rank's part against the
        # loopback's next state
        want_next = saved[name]["next"]
        n = saved[name]["layers"]
        parts = []
        for r in range(SHARDS):
            with np.load(pathlib.Path(saved["dir"])
                         / f"rank{r}-{name}.npz") as data:
                parts.append([data[f"arr_{i}"]
                              for i in range(len(data.files))])
        worst, bitwise, same = 0.0, {}, True
        for i, want_i in enumerate(want_next):
            shared = i < n or 2 * n + 1 <= i < 3 * n + 1     # W, τ
            got_i = parts[0][i] if shared else \
                np.concatenate([p[i] for p in parts])
            kind = ("W" if i < n else "Z" if i < 2 * n else "U"
                    if i == 2 * n else "tau" if i < 3 * n + 1 else "theta")
            bitwise[f"{kind}{i}"] = bool(np.array_equal(got_i, want_i))
            if kind in ("tau", "theta"):
                same &= bitwise[f"{kind}{i}"]
            else:
                scale = float(np.abs(want_i).max()) or 1.0
                worst = max(worst, float(np.abs(got_i - want_i).max())
                            / scale)
            if shared and any(not np.array_equal(p[i], got_i)
                              for p in parts):
                fail(f"3p {name}: the ranks' next {kind} differ")
        print(f"[3p] {name}: one step from the loopback trainer's state, "
              f"{SHARDS} processes vs the loopback: tau/theta equal {same}, "
              f"W/Z/U max rel diff {worst:.3e} (limit {TOL}); bitwise "
              f"{json.dumps(bitwise)}", flush=True)
        if not (same and worst <= TOL):
            fail(f"3p {name}: the process step disagrees with the loopback")
        out[name] = {"steps_ms": head["steps_ms"],
                     "steps_ms_by_rank": [r["steps_ms"] for r in recs],
                     "setup_s": [r["setup_s"] for r in recs],
                     "per_step": per_step, "sent_bytes": head["sent_bytes"],
                     "wire_bytes": head["wire_bytes"],
                     "transport_ms": [r["transport_ms"] for r in recs],
                     "staging_ms": [r["staging_ms"] for r in recs],
                     "vs_loopback_max_rel_err": worst,
                     "vs_loopback_tau_theta_equal": same,
                     "vs_loopback_bitwise": bitwise,
                     "launches": [r["launches"] for r in recs]}
        if "profiled" in head:
            prof = head["profiled"]
            print(f"[3p] {name}: rank 0 profiled step wall "
                  f"{prof['wall_ms']:.1f} ms, device busy "
                  f"{prof['busy_ms']:.1f} ms, device idle share "
                  f"{prof['idle']}; device ms by kind "
                  f"{json.dumps(prof['by_kind'])} [{card}]", flush=True)
            out[name]["profiled"] = prof
    print(f"[3p] summary {json.dumps(out)}", flush=True)
    return out


def time_dense(a_row, mask, z, peak_flops, peak_bw) -> dict:
    """Phase 4: CUDA-event times of the dense launch, its plain version and
    the masked einsum on the same operands, beside the bound."""
    import torch

    from repro_torch.kernels import community_spmm, ref
    maskf = mask.float()

    def library():
        return torch.einsum("kmip,mpc->kic",
                            a_row * maskf[:, :, None, None], z)

    before = counts()
    ms = median_ms(lambda: community_spmm.community_spmm(a_row, z, mask), 7)
    reset_counts(before)                # timing launches do not count
    plain_ms = median_ms(lambda: ref.community_spmm_ref(a_row, z, mask), 5)
    lib_ms = median_ms(library, 5)
    flops, nbytes = dense_work(mask, a_row.shape[2], z.shape[2])
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "live_blocks": int((mask != 0).sum()),
            "layout": community_spmm.operand_layout(a_row, z)}


def serve_in_batches(server, ids, batch: int):
    """``server.serve`` over ``ids`` in request batches of ``batch``."""
    import numpy as np
    return np.concatenate([server.serve(ids[i:i + batch])
                           for i in range(0, len(ids), batch)])


def serve_phase(cfg, admm, g, card: str, dev) -> dict:
    """Phase 5: train at M = 16, serve the launcher's stream cached, cold
    and fused-cold, and check the served embeddings."""
    import numpy as np
    import torch

    from repro_torch.core import gcn, graph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.launch.serve import _drive
    from repro_torch.serve import (CommunityServer, ServeConfig,
                                   zipf_node_stream)

    t0 = time.perf_counter()
    tr = ParallelADMMTrainer(cfg, admm, g, num_parts=SERVE_PARTS, seed=0,
                             config=TrainerConfig.packed(use_kernel=True),
                             device=dev)
    torch.cuda.synchronize()
    lay = tr.layout
    print(f"[5] set-up {time.perf_counter() - t0:.1f} s: M={lay.num_parts}, "
          f"n_pad={lay.n_pad}, row counts "
          f"{sorted(set(lay.eff_row_counts().tolist()))}, max_deg "
          f"{lay.compress().max_deg}, ELL blocks "
          f"{tuple(lay.compress().ell_blocks.shape)}, resident plane "
          f"{lay.device_layout(1).plane_rows} rows", flush=True)
    log = tr.train(SERVE_EPOCHS)
    for i in log.epoch:
        print(f"[5] epoch {i}: step {1e3 * log.epoch_time_s[i]:.1f} ms, "
              f"lagrangian {log.lagrangian[i]:.6f}, residual "
              f"{log.residual[i]:.6e}, train {log.train_acc[i]:.4f}, test "
              f"{log.test_acc[i]:.4f}", flush=True)
    values = (log.lagrangian + log.residual + log.train_acc + log.test_acc)
    if not all(math.isfinite(v) for v in values):
        fail("a non-finite value in the M=16 training log")
    for t in tr.state.weights:
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite weight after the M=16 training")

    m, batch = SERVE_PARTS, 64
    scfg = ServeConfig(embed_capacity=max(m + m // 4, 8), halo_capacity=64,
                       admission="zipf", max_batch=batch)
    stream = zipf_node_stream(g.num_nodes, 2048, s=1.1, seed=1)
    out: dict = {"launches": {}}

    # cached: the serving launcher's drive over the whole stream
    server = CommunityServer.from_trainer(tr, scfg)
    reset_counts()
    res = _drive(server, stream, batch)
    out["launches"]["cached"] = counts()
    st = server.stats()
    out["cached"] = dict(res, hit_rate_total=st["requests"]["hit_rate"],
                         block_computes=st["block_computes"],
                         halo_computes=st["halo_computes"])
    print(f"[5] cached (embed={scfg.embed_capacity}, halo="
          f"{scfg.halo_capacity}, zipf admission), Zipf(1.1) x 2048 "
          f"requests, batch {batch}, timed after the first quarter: p50 "
          f"{res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
          f"{res['qps']:.1f} QPS, hit rate {res['hit_rate']:.4f} (whole "
          f"stream {st['requests']['hit_rate']}), block_computes "
          f"{st['block_computes']}, halo_computes {st['halo_computes']}, "
          f"launches {out['launches']['cached']} [{card}]", flush=True)

    first = len(stream) // batch // 4
    runs = {"cold": ServeConfig(cache_enabled=False, max_batch=batch),
            "fused_cold": ServeConfig(cache_enabled=False, fused=True,
                                      max_batch=batch)}
    cold_servers = {}
    for name, cfg_run in runs.items():
        srv = CommunityServer.from_trainer(tr, cfg_run)
        reset_counts()
        res = time_batches(srv, stream, batch, first, warm=2, timed=6)
        out["launches"][name] = counts()
        st = srv.stats()
        out[name] = dict(res, block_computes=st["block_computes"],
                         halo_computes=st["halo_computes"])
        print(f"[5] {name}: {res['batches']} timed batches of {batch} after "
              f"2 warm-up: p50 {res['p50_ms']:.3f} ms, p99 "
              f"{res['p99_ms']:.3f} ms, {res['qps']:.1f} QPS, hit rate 0, "
              f"block_computes {st['block_computes']}, halo_computes "
              f"{st['halo_computes']}, launches {out['launches'][name]} "
              f"[{card}]", flush=True)
        cold_servers[name] = srv
    launches = out["launches"]
    if launches["cached"]["packed"] == 0 or launches["cold"]["packed"] == 0:
        fail("the cached or cold serving run never launched the packed "
             "kernel")
    if launches["fused_cold"]["fused"] == 0:
        fail("the fused serving run never launched the fused kernel")

    # probe: 64 nodes of every community
    rng = np.random.default_rng(0)
    probe = np.concatenate([rng.choice(np.flatnonzero(server.node_comm == c),
                                       1024 // m, replace=False)
                            for c in range(m)])
    served = serve_in_batches(server, probe, batch)
    a = torch.as_tensor(graph.normalized_adjacency(g.num_nodes, g.edges),
                        device=dev)
    dense = gcn.forward(cfg, a, torch.as_tensor(g.features, device=dev),
                        tr.state.weights)[-1]
    del a
    dense = dense[torch.as_tensor(probe, device=dev)].cpu().numpy()
    scale = float(np.abs(dense).max())
    err_dense = float(np.abs(served - dense).max())
    cold = serve_in_batches(cold_servers["cold"], probe, batch)
    fused = serve_in_batches(cold_servers["fused_cold"], probe, batch)
    err_fused = float(np.abs(fused - served).max())
    bitwise = bool(np.array_equal(cold, served))
    print(f"[5] probe of {len(probe)} nodes from {m} communities: served vs "
          f"dense forward max_abs_err {err_dense:.3e} (rel "
          f"{err_dense / scale:.3e}); cached vs cold bitwise {bitwise}; "
          f"fused vs unfused max_abs_err {err_fused:.3e} (rel "
          f"{err_fused / scale:.3e})", flush=True)
    if not (np.isfinite(served).all() and served.shape == (len(probe),
                                                           cfg.layer_dims[-1])):
        fail("served embeddings are not finite or have the wrong shape")
    if not err_dense <= FUSED_TOL * scale:
        fail("served embeddings disagree with the dense forward pass")
    if not bitwise:
        fail("cached and cold serving disagree")
    if not err_fused <= FUSED_TOL * scale:
        fail("fused and unfused serving disagree")

    ids = np.random.default_rng(2).choice(g.num_nodes, size=2, replace=False)
    feats = (np.asarray(g.features)[ids] + np.random.default_rng(3).normal(
        scale=0.1, size=(2, cfg.layer_dims[0]))).astype(np.float32)
    rep = server.update_features(ids, feats)
    after = serve_in_batches(server, probe, batch)
    new_features = np.asarray(g.features).copy()
    new_features[ids] = feats
    fresh = serve_in_batches(
        CommunityServer(cfg, lay, tr.state.weights, new_features, scfg,
                        device=tr.device), probe, batch)
    same = bool(np.array_equal(after, fresh))
    print(f"[5] update of {len(ids)} nodes: dirty communities per hop "
          f"{[len(c) for c in rep['dirty']]}, dropped {len(rep['embed'])} "
          f"embed / {len(rep['halo'])} halo entries; post-update serving "
          f"equals a fresh server bitwise: {same}", flush=True)
    if not same:
        fail("post-update serving differs from a freshly built server")
    out["probe"] = {"nodes": len(probe), "rel_err_vs_dense": err_dense / scale,
                    "cached_vs_cold_bitwise": bitwise,
                    "rel_err_fused_vs_unfused": err_fused / scale,
                    "post_update_vs_fresh_bitwise": same}
    print(f"[5] serving summary {json.dumps(out)}", flush=True)
    return out


def time_packed(blocks, off, mask, rows, nbrs, z, peak_flops, peak_bw,
                w=None, self_mask=None) -> dict:
    """Phase 6: CUDA-event times of the packed (or, with ``w``, the fused)
    kernel, its plain version and the gather + einsum (+ matmul)
    composition on the same operands, beside the bound."""
    import torch

    from repro_torch.kernels import community_spmm, ref
    if self_mask is not None:           # the halo pass: self slot masked
        mask = mask * (1 - self_mask.to(mask.dtype))
        nbrs = (nbrs * (mask != 0)).to(torch.int32)
    n = blocks.shape[2]
    lane = torch.arange(n, device=z.device)
    # rows past a slot's count (or past the plane) contribute nothing
    idx = torch.clamp(off.long()[..., None] + lane, max=z.shape[0] - 1)
    keep = ((lane < nbrs[..., None]) & (mask[..., None] != 0)).float()

    def composition():
        zg = z[idx] * keep[..., None]
        out = torch.einsum("mdip,mdpc->mic", blocks, zg)
        return out if w is None else out @ w

    before = counts()
    if w is None:
        ms = median_ms(lambda: community_spmm.community_spmm_ell_packed(
            blocks, off, mask, z, rows, nbrs), 7)
        plain_ms = median_ms(lambda: ref.community_spmm_ell_packed_einsum(
            blocks, off, mask, z, rows, nbrs), 5)
    else:
        ms = median_ms(lambda: community_spmm.community_spmm_ell_fused(
            blocks, off, mask, z, w, rows, nbrs), 7)
        plain_ms = median_ms(lambda: ref.community_spmm_ell_fused_einsum(
            blocks, off, mask, z, w, rows, nbrs), 5)
    reset_counts(before)                # timing launches do not count
    lib_ms = median_ms(composition, 5)
    flops, nbytes = packed_work(blocks, off, mask, rows, nbrs, z.shape[0],
                                z.shape[1],
                                None if w is None else w.shape[1])
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "live_slots": int((mask != 0).sum())}
    if w is None:
        out["layout"] = community_spmm.operand_layout(blocks, z)
    return out


def fista_phase(trainer, state, admm, peak_flops: float, peak_bw: float,
                card: str) -> dict:
    """Phase 3's Z_L prox check on the card, on the (b, u, labels, mask, Z,
    denom) the trainer hands ``ops.fista_lanes`` in one step from
    ``state``: the kernel against the plain host loop
    (``parallel.fista_lanes``) on the same tensors, Z within TOL · max |Z|
    of each lane and each lane's final Lipschitz constant bitwise; then
    both timed, and the kernel's bound from its least bytes and FLOPs
    (``fista.work``, an exp or a log counted as one)."""
    import torch

    from repro_torch.core import parallel
    from repro_torch.kernels import fista, ops

    seen = []
    real = ops.fista_lanes

    def spy(admm_, *args):
        seen.append(args)
        return real(admm_, *args)

    ops.fista_lanes = spy
    try:
        trainer.next_state(state, use_kernel=True)
    finally:
        ops.fista_lanes = real
    if len(seen) != 1:
        fail(f"one step called the Z_L prox {len(seen)} times, not once")
    args = seen[0]
    b, u, labels, mask, z0, denom = args
    k, n, c = z0.shape
    got, lip, probes = fista.fista_lanes(
        b.detach().contiguous(), u.detach().contiguous(),
        labels.to(torch.int32).contiguous(),
        mask.detach().float().contiguous(), z0.detach().contiguous(),
        denom.detach(), rho=admm.rho, growth=admm.backtrack_growth,
        rtol=admm.backtrack_rtol, max_backtracks=admm.max_backtracks,
        iters=admm.fista_iters, stats=True)
    found = []
    search = parallel._lane_search

    def spy_search(accepted, step0, admm_):
        found.append(search(accepted, step0, admm_))
        return found[-1]

    parallel._lane_search = spy_search
    try:
        want = parallel.fista_lanes(admm, *args)
    finally:
        parallel._lane_search = search
    want_lip = found[-1] * 0.9
    rel = [((got[m] - want[m]).abs().max()
            / want[m].abs().max().clamp_min(1e-30)).item() for m in range(k)]
    bitwise = sum(bool(torch.equal(got[m], want[m])) for m in range(k))
    lip_equal = bool(torch.equal(lip, want_lip))
    print(f"[3] Z_L prox on the trainer's inputs ({k} x {n} x {c}): kernel "
          f"vs plain loop max rel err by lane {[f'{r:.3e}' for r in rel]} "
          f"(limit {TOL:g}), bitwise lanes {bitwise}/{k}, final L bitwise "
          f"{lip_equal} ({lip.tolist()}), probes {probes.tolist()}",
          flush=True)
    if not max(rel) <= TOL:
        fail(f"the FISTA kernel's Z_L differs from the plain loop's by "
             f"{max(rel):.3e} of max |Z|")
    if not lip_equal:
        fail(f"the FISTA kernel's final L {lip.tolist()} differ from the "
             f"plain loop's {want_lip.tolist()}")
    before = fista.launches
    ms = median_ms(lambda: real(admm, *args), 20, inner=10)
    fista.launches = before               # timing launches do not count
    plain_ms = median_ms(lambda: parallel.fista_lanes(admm, *args), 5)
    flops, nbytes = fista.work(k, n, c, admm.fista_iters)
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
    lay = fista.layout(n, c)
    print(f"[3] Z_L prox times: kernel {ms:.4f} ms, plain loop "
          f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.5f} ms ("
          f"{'operations' if t_ops >= t_bytes else 'bytes'}; "
          f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB); cluster "
          f"{lay['cluster']} x {lay['threads']} threads, {lay['rows']} rows "
          f"a block, {lay['smem_bytes']} B shared [{card}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mflop": flops / 1e6, "mbytes": nbytes / 1e6,
            "max_rel_err": max(rel),
            "max_abs_err": (got - want).abs().max().item(),
            "bitwise_lanes": bitwise, "lip_bitwise": lip_equal,
            "timed_at": {"k": k, "n_pad": n, "C": c,
                         "iters": admm.fista_iters},
            "layout": lay}


def objective_gap(trainer) -> float:
    """Largest relative difference between the kernel path and the plain
    path over every W- and Z-update objective value and gradient at the
    trainer's current state."""
    obj_k = trainer.objectives(use_kernel=True)
    obj_p = trainer.objectives(use_kernel=False)
    worst = 0.0
    for kind in ("w", "z"):
        for (vk, gk), (vp, gp) in zip(obj_k[kind], obj_p[kind]):
            for a, b in ((vk, vp), (gk, gp)):
                worst = max(worst, rel_err(a, b)[1])
    return worst


# ---------------------------------------------------------------------------
# the language-model path: SSD scan, flash attention, Mamba-2 1.3B
# ---------------------------------------------------------------------------

def ssd_operands(gen, b, s, h, p, g, n, dtype, dev):
    """x, dt, a, B, C for the SSD scan: x, B, C standard normal in
    ``dtype``; dt = 0.5 |N(0, 1)| and a = -|N(0, 1)| in f32."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (randn(b, s, h, p).to(dtype), 0.5 * randn(b, s, h).abs(),
            -randn(h).abs(), randn(b, s, g, n).to(dtype),
            randn(b, s, g, n).to(dtype))


def ssd_work(x, b_mat) -> tuple[float, float]:
    """(FLOPs, bytes) of the SSD scan, counted as its least arithmetic: the
    recurrence itself, per (batch, position, head) the state's decay (N·P
    multiplies), its update by B ⊗ (dt x) (P multiplies, N·P FMAs) and the
    output C·h (N·P FMAs), 5·N·P + P.  Every chunked form does more: at
    4 x 4096 this is 43.0 GFLOP, the FFMA route's three passes do 63.4 and
    the chunks' dual form 86.1.  x, dt, a, B and C read once, y written
    once."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    flops = b * s * h * (5 * n * p + p)
    elt = x.element_size()
    nbytes = 2 * b * s * h * p * elt + b * s * h * 4 + h * 4 \
        + 2 * b * s * g * n * elt
    return flops, nbytes


def attention_pairs(s: int, causal: bool, window) -> float:
    """(query, key) pairs the causal / window mask keeps, per head."""
    import numpy as np
    q = np.arange(s, dtype=np.float64)
    hi = q + 1 if causal else np.full(s, float(s))
    lo = np.maximum(q - window + 1, 0) if window is not None else 0.0
    return float((hi - lo).sum())


def flash_work(q, k, causal: bool, window) -> tuple[float, float]:
    """(FLOPs, bytes) of attention: 4·hd per live (query, key) pair (q·k
    and p·v); q, k, v read once, the output written once."""
    b, s, hq, hd = q.shape
    flops = 4.0 * hd * b * hq * attention_pairs(s, causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, nbytes


def check_lm_case(kind: str, name: str, out, want, limit: float,
                  log) -> None:
    import torch
    err, rel = rel_err(out, want)
    ok = (bool(torch.isfinite(out).all()) and out.shape == want.shape
          and out.dtype == want.dtype and rel <= limit)
    log.append({"case": name, "max_abs_err": err, "max_rel_err": rel})
    print(f"[7] {kind} {name}: max_abs_err {err:.3e} rel {rel:.3e} (limit "
          f"{limit:.2e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the {kind} kernel disagrees with its plain version on {name}")


SSD_CHECKS = [      # (name, b, s, h, p, g, n, dtype)
    ("prefill 4x4096 bf16", 4, 4096, 64, 64, 1, 128, "bfloat16"),
    ("prefill 4x4096 f32", 4, 4096, 64, 64, 1, 128, "float32"),
    ("1x32768 bf16", 1, 32768, 64, 64, 1, 128, "bfloat16"),
    ("1x32768 f32", 1, 32768, 64, 64, 1, 128, "float32"),
    ("ragged S=1000 (chunk 8) bf16", 1, 1000, 64, 64, 1, 128, "bfloat16"),
    ("S=100 < chunk bf16", 2, 100, 64, 64, 1, 128, "bfloat16"),
    ("G=2 2x2048 bf16", 2, 2048, 64, 64, 2, 128, "bfloat16"),
    # a mamba2-1.3b rank's heads over 1 x 2 model ranks (phase 17b)
    ("mamba2-1.3b rank heads 1x2 2x4096 H32 bf16", 2, 4096, 32, 64, 1, 128,
     "bfloat16"),
]
# a context-parallel rank's query rows against every key (phase 14's
# context branch): (name, b, s, model ranks, hq, hkv, hd, causal, window,
# dtype); each rank past the first at its query offset
FLASH_OFFSET_CHECKS = [
    ("gemma-2b context 1x2 S=4096 Hq8 Hkv1 hd256 causal bf16", 1, 4096, 2,
     8, 1, 256, True, None, "bfloat16"),
    ("qwen2-7b context 1x4 S=4096 Hq28 Hkv4 hd128 causal bf16", 1, 4096, 4,
     28, 4, 128, True, None, "bfloat16"),
    ("recurrentgemma-9b local context 1x4 S=8192 Hq16 Hkv1 hd256 window "
     "2048 bf16", 1, 8192, 4, 16, 1, 256, True, 2048, "bfloat16"),
    # a recurrentgemma-9b rank's query rows over 1 x 2 (phase 18b's launch)
    ("recurrentgemma-9b local context 1x2 2x4096 Hq16 Hkv1 hd256 window "
     "2048 bf16", 2, 4096, 2, 16, 1, 256, True, 2048, "bfloat16"),
    ("recurrentgemma-9b local context 1x2 2x4096 Hq16 Hkv1 hd256 window "
     "2048 f32", 2, 4096, 2, 16, 1, 256, True, 2048, "float32"),
    ("gemma-2b context 1x2 S=2048 Hq8 Hkv1 hd256 causal f32", 1, 2048, 2, 8,
     1, 256, True, None, "float32"),
    ("qwen2-7b context 1x4 S=2048 Hq28 Hkv4 hd128 causal f32", 1, 2048, 4,
     28, 4, 128, True, None, "float32"),
]
# (name, b, s, hq, hkv, hd, causal, window, dtype[, v_hd]): a row with
# v_hd draws v at that head_dim and pads it with zeros to hd (MLA's attend)
FLASH_CHECKS = [
    ("qwen2-7b S=4096 Hq28 Hkv4 hd128 causal bf16", 1, 4096, 28, 4, 128,
     True, None, "bfloat16"),
    ("gemma-2b S=4096 Hq8 Hkv1 hd256 causal bf16", 1, 4096, 8, 1, 256, True,
     None, "bfloat16"),
    ("recurrentgemma-9b local S=8192 Hq16 Hkv1 hd256 window 2048 bf16", 1,
     8192, 16, 1, 256, True, 2048, "bfloat16"),
    ("non-causal S=2048 Hq8 Hkv2 hd128 bf16", 1, 2048, 8, 2, 128, False,
     None, "bfloat16"),
    ("ragged S=3000 Hq28 Hkv4 hd128 causal bf16", 1, 3000, 28, 4, 128, True,
     None, "bfloat16"),
    ("hd80 S=2048 Hq16 Hkv4 causal bf16", 2, 2048, 16, 4, 80, True, None,
     "bfloat16"),
    ("qwen2-7b heads S=2048 causal f32", 1, 2048, 28, 4, 128, True, None,
     "float32"),
    ("non-causal window 127 S=1000 Hq8 Hkv2 hd128 bf16", 1, 1000, 8, 2, 128,
     False, 127, "bfloat16"),
    # a deepseek-moe-16b rank's heads over 1 x 2 model ranks (phase 14b)
    ("deepseek-moe-16b rank heads 1x2 S=2048 Hq8 Hkv8 hd128 causal bf16", 2,
     2048, 8, 8, 128, True, None, "bfloat16"),
    # a deepseek-v3-671b rank's MLA heads over 1 x 2 model ranks (phase 17c)
    ("deepseek-v3-671b rank heads 1x2 S=2048 Hq64 Hkv64 qk192 v128 padded "
     "causal bf16", 2, 2048, 64, 64, 192, True, None, "bfloat16", 128),
    ("gemma-2b heads S=2048 Hq8 Hkv1 hd256 causal f32", 1, 2048, 8, 1, 256,
     True, None, "float32"),
]
# three bf16, the two f32
FLASH_TIMED = [FLASH_CHECKS[i] for i in (0, 1, 2, 6, 10)]
SSD_PROFILED = 10   # SSD calls in the profiled window of phase 9
# calls per timed window of the LM kernels and SDPA (the card runs one while
# the host enqueues the next: a sub-millisecond kernel is not charged the
# host's launch time)
INNER = 10


def check_lm_kernels(gen, dev) -> tuple[list, list]:
    """Phase 7: the SSD scan and flash attention kernels against their plain
    versions on the same CUDA tensors; each SSD case also against the
    plain three-pass form, with the tensor-core kernel's bf16 roundings
    (bf16) or in f32 (reported)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    ssd_checks: list[dict] = []
    for name, b, s, h, p, g, n, dtype in SSD_CHECKS:
        dtype = getattr(torch, dtype)
        tc = dtype == torch.bfloat16
        args = ssd_operands(gen, b, s, h, p, g, n, dtype, dev)
        before = ssd.ssd_tc_launches
        out, _ = ops.ssd_scan(*args, chunk=256)
        torch.cuda.synchronize()
        if ssd.ssd_tc_launches - before != int(tc):
            fail(f"ssd_scan {name} took the wrong route: "
                 f"{ssd.ssd_tc_launches - before} tensor-core launches")
        want = ref.ssd_scan_ref(*args, chunk=256)
        check_lm_case("ssd_scan", name, out, want,
                      SSD_F32_TOL if dtype == torch.float32 else BF16_TOL,
                      ssd_checks)
        ssd_checks[-1]["route"] = "tensor cores (wgmma)" if tc else "FFMA"
        # the kernel beside the plain three-pass form it splits the scan
        # as: with the tensor-core route's bf16 roundings, or in f32
        emulated = ref.ssd_scan_three_pass(*args, chunk=256, round_bf16=tc)
        e_err, e_rel = rel_err(out, emulated)
        p_err, p_rel = rel_err(emulated, want)
        ssd_checks[-1].update(rel_err_vs_emulated=e_rel,
                              emulated_rel_err_vs_plain=p_rel)
        form = "with its bf16 roundings" if tc else "in f32"
        print(f"[7]   {ssd_checks[-1]['route']} route; vs the three-pass "
              f"form {form}: max_abs_err {e_err:.3e} rel {e_rel:.3e}; that "
              f"form vs the plain version: rel {p_rel:.3e} (reported)",
              flush=True)
        del emulated
        del args, out, want
    flash_checks: list[dict] = []
    for name, b, s, hq, hkv, hd, causal, window, dtype, *v_hd in \
            FLASH_CHECKS:
        dtype = getattr(torch, dtype)
        vd = v_hd[0] if v_hd else hd
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                 (b, s, hkv, vd)))
        v = torch.nn.functional.pad(v, (0, hd - vd))
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        check_lm_case("flash_attention", name, out, want,
                      FLASH_F32_TOL if dtype == torch.float32 else BF16_TOL,
                      flash_checks)
        del q, k, v, out, want
    # the context-parallel ranks' query rows at a query offset (phase 14)
    from repro_torch.kernels import flash_attention as flash
    for name, b, s, nm, hq, hkv, hd, causal, window, dtype in \
            FLASH_OFFSET_CHECKS:
        dtype = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        n = s // nm
        for m in range(1, nm):
            rows = q[:, m * n:(m + 1) * n].contiguous()
            before = flash.flash_offset_launches
            out = ops.flash_attention(rows, k, v, causal=causal,
                                      window=window, q_offset=m * n)
            torch.cuda.synchronize()
            if flash.flash_offset_launches != before + 1:
                fail(f"flash_attention {name}: the offset launch was not "
                     f"counted")
            want = ref.flash_attention_ref(rows, k, v, causal=causal,
                                           window=window, q_offset=m * n)
            check_lm_case("flash_attention",
                          f"{name}, rank {m}'s rows at offset {m * n}", out,
                          want, FLASH_F32_TOL if dtype == torch.float32
                          else BF16_TOL, flash_checks)
            flash_checks[-1]["q_offset"] = m * n
            del rows, out, want
        del q, k, v
    torch.cuda.empty_cache()
    return ssd_checks, flash_checks


def probs_gap(logits, ref_logits) -> tuple[float, bool]:
    """(max |Δp|, allclose at the decode test's rtol/atol) of the softmax
    distributions."""
    import torch
    p, p_ref = (torch.softmax(x.float(), dim=-1) for x in (logits, ref_logits))
    gap = float((p - p_ref).abs().max())
    return gap, bool(torch.allclose(p, p_ref, rtol=DECODE_RTOL,
                                    atol=DECODE_ATOL))


def decode_run(model, params, tokens) -> tuple[object, list]:
    """``init_cache`` and one ``decode_step`` per token: (logits (B, S, V),
    host-clock ms of each step, ending in ``synchronize()``)."""
    import torch
    b, s = tokens.shape
    caches = model.init_cache(b, s, device=tokens.device)
    logits, step_ms = [], []
    for t in range(s):
        t0 = time.perf_counter()
        out, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(out[:, 0])
    return torch.stack(logits, dim=1), step_ms


def mamba_phase(card: str, dev) -> dict:
    """Phase 8: Mamba-2 1.3B at its published widths and depth, bf16, with
    random weights from a generator on the card: prefill through the SSD
    kernel and through the plain path, timed forwards, cached decode, and
    decode against the kernel forward in f32."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import transformer
    from repro_torch.models.build import make_model

    cfg = get_config("mamba2-1.3b")
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = []
    transformer.tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    print(f"[8] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}; {n_params:,} parameters on the card "
          f"(param_count() {cfg.param_count():,}, which leaves out norms, "
          f"conv biases and the per-head a_log / dt_bias / d_skip), "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
          f"GB; init {time.perf_counter() - t0:.2f} s", flush=True)

    b, s = PREFILL
    toks = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=0))
    batch = {"tokens": torch.as_tensor(toks["tokens"], device=dev)}
    out = {}
    with torch.inference_mode():
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits_k, _, _ = model.forward(params, batch, use_kernel=True,
                                       last_only=True)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reset_counts()
        t0 = time.perf_counter()
        logits_p, _, _ = model.forward(params, batch, use_kernel=False,
                                       last_only=True)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_launches = counts()
    if (launches["ssd"] != cfg.num_layers
            or launches["ssd_tc"] != cfg.num_layers
            or plain_launches["ssd"] != 0):
        fail(f"ssd_scan launches: {launches['ssd']} on the kernel forward, "
             f"{launches['ssd_tc']} of them on the tensor cores (expected "
             f"{cfg.num_layers} and {cfg.num_layers}), "
             f"{plain_launches['ssd']} on the plain one (expected 0)")
    if tuple(logits_k.shape) != (b, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits_k).all() & torch.isfinite(logits_p).all()):
        fail(f"prefill logits of shape {tuple(logits_k.shape)} or not finite")
    err, rel = rel_err(logits_k, logits_p)
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    print(f"[8] prefill {b} x {s} tokens, last-token logits "
          f"{tuple(logits_k.shape)} f32: kernel path vs plain path max "
          f"|diff| {err:.4e}, rel {rel:.4e} (limit {LOGIT_TOL:.1e}), argmax "
          f"agreement {agree:.2f}; ssd_scan launches {launches['ssd']} on the "
          f"kernel forward ({launches['ssd_tc']} on the tensor cores), "
          f"{plain_launches['ssd']} on the plain one; peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    if not rel <= LOGIT_TOL:
        fail(f"prefill logits, kernel vs plain path: rel {rel:.3e}")
    out.update(launches=launches["ssd"], tc_launches=launches["ssd_tc"],
               flash_launches=launches["flash"],
               flash_tc_launches=launches["flash_tc"],
               logits_max_abs_err=err,
               logits_rel_err=rel, argmax_agreement=agree)

    def forward():
        model.forward(params, batch, use_kernel=True, last_only=True)
        torch.cuda.synchronize()

    with torch.inference_mode():
        before = counts()
        forward()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward()
            times.append(1e3 * (time.perf_counter() - t0))
        wall_us, busy_us, idle, events = profiled(forward)
        reset_counts(before)            # timing launches do not count
    med = statistics.median(times)
    kinds = device_ms_by_kind(events)
    out.update(forward_ms=times, forward_median_ms=med,
               tokens_per_s=b * s / (med / 1e3), plain_forward_ms=plain_ms,
               first_forward_ms=first_ms, idle=idle,
               forward_device_ms=kinds)
    print(f"[8] prefill forward through the kernel: median {med:.1f} ms of "
          f"{[round(t, 1) for t in times]} after one warm-up (first call "
          f"{first_ms:.1f} ms) = {out['tokens_per_s']:,.0f} tokens/s; plain "
          f"forward {plain_ms:.1f} ms (one call); profiled forward: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, idle "
          f"share {idle}; device ms by kind {json.dumps(kinds)} [{card}]",
          flush=True)
    del logits_k, logits_p, batch

    b, s = DECODE
    dec = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=0))
    tokens = torch.as_tensor(dec["tokens"], device=dev)
    with torch.inference_mode():
        dec_logits, step_ms = decode_run(model, params, tokens)
        caches = model.init_cache(b, s, device=dev)
        d_wall, d_busy, d_idle, d_events = profiled(
            lambda: model.decode_step(params, caches, tokens[:, :1]))
        full_bf16, _, _ = model.forward(params, {"tokens": tokens},
                                        use_kernel=True)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = make_model(cfg32)
        params32 = transformer.tree_map(lambda t: t.float(), params)
        dec32, _ = decode_run(model32, params32, tokens)
        before32 = counts()
        full32, _, _ = model32.forward(params32, {"tokens": tokens},
                                       use_kernel=True)
        f32_ssd = counts()["ssd"] - before32["ssd"]
        f32_ssd_tc = counts()["ssd_tc"] - before32["ssd_tc"]
    torch.cuda.synchronize()
    gap32, ok32 = probs_gap(dec32, full32)
    gap16, _ = probs_gap(dec_logits, full_bf16)
    _, rel32 = rel_err(dec32, full32)
    _, rel16 = rel_err(dec_logits, full_bf16)
    steps = sorted(step_ms[1:])
    n_dev = sum(1 for e in d_events if e.device_type == DeviceType.CUDA)
    out.update(decode_step_ms=step_ms,
               decode_median_ms=statistics.median(step_ms[1:]),
               decode_p90_ms=steps[int(0.9 * (len(steps) - 1))],
               decode_profiled={"wall_ms": d_wall / 1e3,
                                "busy_ms": d_busy / 1e3, "idle": d_idle,
                                "device_events": n_dev},
               decode_f32_max_abs_dp=gap32, decode_bf16_max_abs_dp=gap16,
               decode_f32_logits_rel=rel32, decode_bf16_logits_rel=rel16,
               f32_forward_ssd_launches=f32_ssd)
    print(f"[8] decode {b} requests x {s} tokens (init_cache({b}, {s}), one "
          f"decode_step per token): per token median "
          f"{out['decode_median_ms']:.2f} ms, p90 {out['decode_p90_ms']:.2f} "
          f"ms, first {step_ms[0]:.2f} ms = "
          f"{b * 1e3 / out['decode_median_ms']:,.0f} tokens/s; profiled step: "
          f"wall {d_wall / 1e3:.2f} ms, device busy {d_busy / 1e3:.2f} ms, "
          f"idle share {d_idle}, {n_dev} device events [{card}]", flush=True)
    print(f"[8] decode vs the kernel forward over the same {s} tokens, f32 "
          f"weights ({f32_ssd} FFMA ssd_scan launches in that forward, "
          f"{f32_ssd_tc} on the tensor cores): max |dp| {gap32:.3e}, "
          f"allclose rtol {DECODE_RTOL} atol "
          f"{DECODE_ATOL}: {'ok' if ok32 else 'FAIL'}; logits rel "
          f"{rel32:.3e} (limit {DECODE_LOGIT_TOL:.0e}); bf16 weights "
          f"(reported, no limit): max |dp| {gap16:.3e}, logits rel "
          f"{rel16:.3e}", flush=True)
    if not (ok32 and rel32 <= DECODE_LOGIT_TOL
            and bool(torch.isfinite(dec_logits).all())):
        fail(f"f32 decode disagrees with the forward: max |dp| {gap32:.3e}, "
             f"logits rel {rel32:.3e}")
    if f32_ssd != cfg.num_layers or f32_ssd_tc:
        fail(f"the f32 forward made {f32_ssd} ssd_scan launches, "
             f"{f32_ssd_tc} on the tensor cores; expected {cfg.num_layers} "
             f"on the FFMA route")
    del params, params32, dec_logits, dec32, full_bf16, full32, caches
    torch.cuda.empty_cache()
    print(f"[8] Mamba-2 summary {json.dumps(out)}", flush=True)
    return out


def ssd_pass_ms(call, call_ms: float) -> tuple:
    """(device ms a call of each SSD pass, profiled launches of each, the
    passes' sum over ``call_ms``) from SSD_PROFILED profiled calls: each
    pass's mean over the launches the profiler traced.  After earlier
    profiled windows in the same process the profiler drops some of a
    window's launches (a third to a half in the whole script), while those
    it keeps last as long as phase 8's; so the mean, not the sum over
    SSD_PROFILED, with the count beside it.
    The ms are None (withheld, and said so) unless every pass was traced
    and the means add up to 0.85-1.05 of the call's CUDA-event time."""
    events = profiled(lambda: [call() for _ in range(SSD_PROFILED)])[3]
    kinds = {k: v for k, v in device_ms_by_kind(events).items()
             if k.startswith("ssd") and " pass " in k}
    traced = {k: v["events"] for k, v in kinds.items()}
    passes = {k: round(v["ms"] / v["events"], 4) for k, v in kinds.items()}
    share = sum(passes.values()) / call_ms
    if len(kinds) != 3 or not 0.85 <= share <= 1.05:
        print(f"[9]   per-pass device ms withheld: the profiler traced "
              f"{json.dumps(traced)} launches in {SSD_PROFILED} calls, "
              f"their mean ms {json.dumps(passes)} sum to {share:.3f} of "
              f"the call", flush=True)
        passes = None
    return passes, traced, share


def time_lm_kernels(gen, dev, peak_fp32: float, peak_bf16: float,
                    peak_bw: float, card: str) -> tuple[dict, dict]:
    """Phase 9: CUDA-event times of the SSD scan and flash attention
    kernels, their plain versions and (flash) scaled_dot_product_attention,
    beside the card's bound for the inputs' type."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.roofline import bound

    def peak(dtype):
        return peak_bf16 if dtype == torch.bfloat16 else peak_fp32

    ssd_t = {}
    for (b, s), dtype in ((PREFILL, torch.bfloat16),
                          (SSD_LONG, torch.bfloat16),
                          (PREFILL, torch.float32),
                          (SSD_LONG, torch.float32)):
        args = ssd_operands(gen, b, s, 64, 64, 1, 128, dtype, dev)
        tc = dtype == torch.bfloat16
        before = counts()
        ms = median_ms(lambda: ops.ssd_scan(*args, chunk=256), 5,
                       inner=INNER)
        passes, traced, share = ssd_pass_ms(
            lambda: ops.ssd_scan(*args, chunk=256), ms)
        reset_counts(before)            # timing launches do not count
        plain_ms = median_ms(lambda: ref.ssd_scan_ref(*args, chunk=256), 3,
                             warmup=1)
        flops, nbytes = ssd_work(args[0], args[3])
        bnd, by = bound(flops, nbytes, peak(dtype), peak_bw)
        key = f"{b}x{s}" + ("" if tc else " f32")
        lay = (ssd.tc_layout if tc else ssd.ffma_layout)(b, s, 64, 64, 128,
                                                          256)
        blocks = (f"{math.prod(lay['pass1_grid'])} / "
                  f"{math.prod(lay['pass2_grid'])} / "
                  f"{math.prod(lay['pass3_grid'])} blocks in passes 1-3, "
                  f"{lay['scratch_bytes'] / 1e6:.1f} MB of scratch")
        ssd_t[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bnd, "bound_by": by, "gflop": flops / 1e9,
                      "mbytes": nbytes / 1e6,
                      "tflop_per_s": flops / ms / 1e9,
                      "route": "tensor cores (wgmma)" if tc else "FFMA",
                      "device_ms_by_pass": passes,
                      "profiled_launches_by_pass": traced,
                      "profiled_passes_share_of_call": share}
        print(f"[9] ssd_scan {key} {'bf16' if tc else ''} (H 64, P 64, N "
              f"128, chunk 256), {ssd_t[key]['route']}, {blocks}: kernel "
              f"{ms:.3f} ms ({ssd_t[key]['tflop_per_s']:.1f} TFLOP/s), plain "
              f"version {plain_ms:.3f} ms, no single PyTorch call, bound "
              f"{bnd:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB); device ms a call by pass "
              f"{json.dumps(passes)} (profiled launches "
              f"{json.dumps(traced)} of {SSD_PROFILED} calls, their sum "
              f"{share:.3f} of the call) [{card}]", flush=True)
        del args
    flash_t = {}
    F = torch.nn.functional
    print(f"[9] card before the flash timings: {clocks_line()}", flush=True)
    for name, b, s, hq, hkv, hd, causal, window, dtype in FLASH_TIMED:
        dtype = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(s, device=dev)
            mask = (pos[:, None] - pos[None, :] < window) & (
                pos[:, None] >= pos[None, :] if causal else True)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        before = counts()
        ms = median_ms(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window), 5, inner=INNER)
        reset_counts(before)            # timing launches do not count
        plain_ms = median_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), 3, warmup=1)
        lib_ms = median_ms(sdpa, 5, inner=INNER)
        flops, nbytes = flash_work(q, k, causal, window)
        bnd, by = bound(flops, nbytes, peak(dtype), peak_bw)
        tc = dtype == torch.bfloat16
        route = "tensor cores (wgmma)" if tc else "FFMA"
        # a block per (batch, query head, tile of query rows)
        rows = (flash.tc_layout if tc else flash.ffma_layout)(hd)["block_q"]
        blocks = b * hq * -(-s // rows)
        flash_t[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bnd, "bound_by": by,
                         "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                         "tflop_per_s": flops / ms / 1e9, "route": route,
                         "blocks": blocks}
        print(f"[9] flash_attention {name}: {route}, {blocks} blocks: "
              f"kernel {ms:.3f} ms ({flash_t[name]['tflop_per_s']:.1f} "
              f"TFLOP/s), plain version {plain_ms:.3f} ms, "
              f"scaled_dot_product_attention {lib_ms:.3f} ms, bound "
              f"{bnd:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) [{card}]", flush=True)
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return ssd_t, flash_t


# ---------------------------------------------------------------------------
# the attention families: full-width qwen2-7b, deepseek-moe-16b and
# recurrentgemma-9b, the other families at their reduced configurations
# ---------------------------------------------------------------------------

# (arch, prefill batch × tokens, decode requests × tokens, flash launches a
# forward): the published widths and depth in bf16; qwen2-7b and
# recurrentgemma-9b prefill above the attention chunk (2,048), where the
# plain route runs its chunk loop and recurrentgemma's local window bites
FAMILIES = [("qwen2-7b", (2, 4096), (2, 64), 28),
            ("deepseek-moe-16b", (2, 2048), (2, 32), 28),
            ("recurrentgemma-9b", (2, 4096), (2, 64), 12)]
# qwen2-7b: one batch of requests against a cache of max_len, steps timed
BATCH_DECODE = (32, 4096, 16)
# the other families at their reduced configurations, kernel route vs plain
# route, in f32 (the FFMA flash kernel; last-token logits within
# F32_LOGIT_TOL · max) and bf16 (the tensor-core kernel; LOGIT_TOL):
# (arch, flash launches a forward)
REDUCED_FAMILIES = [("gemma-2b", 2), ("nemotron-4-15b", 2),
                    ("deepseek-v3-671b", 2), ("moonshot-v1-16b-a3b", 2),
                    ("internvl2-2b", 2), ("seamless-m4t-medium", 4)]
REDUCED_SEQ = (2, 4096)        # batch × positions (vision prefix included)
F32_LOGIT_TOL = 1e-4
# an MoE model's bf16 kernel vs plain gap is reported, not held: top-k
# routing is discontinuous, and a one-ulp bf16 difference at a router input
# moves a token to another expert.  Its limit is held in f32, where the
# routes agree to rounding; at full width on the first F32_CUT_LAYERS
# layers (1 dense + 3 MoE for deepseek-moe-16b; the f32 weights of every
# layer would not fit beside the bf16 ones)
F32_CUT_LAYERS = 4


class FlashCalls:
    """Records (dtype, S, head_dim, causal, window) of every call that
    reaches the flash launcher while active (the launcher's own counts are
    what the checks read)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as flash
        self.module, self.launch, self.calls = flash, flash.flash_attention, []

        def record(q, k, v, *, causal=True, window=None, q_offset=0):
            self.calls.append((str(q.dtype).removeprefix("torch."),
                               q.shape[1], q.shape[-1], causal, window))
            return self.launch(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
        flash.flash_attention = record
        return self

    def __exit__(self, *exc) -> None:
        self.module.flash_attention = self.launch


def calls_text(calls) -> str:
    kinds: dict = {}
    for call in calls:
        kinds[call] = kinds.get(call, 0) + 1
    return ", ".join(f"{n} x ({dt}, S {s}, hd {hd}, "
                     f"{'causal' if causal else 'non-causal'}, window "
                     f"{window})" for (dt, s, hd, causal, window), n
                     in kinds.items())


def family_batch(cfg, b: int, s: int, dev, gen) -> dict:
    """Tokens from the synthetic stream; a vision model's prefix (random
    embeddings) and its text make ``s`` positions; an encoder-decoder's
    ``s`` random frames go with ``s // 2`` decoder tokens."""
    import torch

    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import layers
    dt = layers.dtype_of(cfg)
    toks = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=0))
    batch = {"tokens": torch.as_tensor(toks["tokens"], device=dev)}
    if cfg.arch_type == "vlm":
        npfx = cfg.frontend.num_embeddings
        batch["tokens"] = batch["tokens"][:, npfx:]
        batch["vision_embeds"] = torch.randn(
            (b, npfx, cfg.d_model), generator=gen, device=dev).to(dt)
    if cfg.is_encoder_decoder:
        batch["tokens"] = batch["tokens"][:, :s // 2]
        batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=dev).to(dt)
    return batch


def kernel_vs_plain(model, params, batch) -> dict:
    """One forward through the flash kernel and one through the plain
    route (last-token logits), each with the launch counts set to 0 just
    before and read just after."""
    import torch
    out = {}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        for route in (True, False):
            reset_counts()
            with FlashCalls() as rec:
                t0 = time.perf_counter()
                logits, _, _ = model.forward(params, batch, use_kernel=route,
                                             last_only=True)
                torch.cuda.synchronize()
            key = "kernel" if route else "plain"
            out[key] = {"logits": logits, "launches": counts(),
                        "calls": rec.calls,
                        "ms": 1e3 * (time.perf_counter() - t0)}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    err, rel = rel_err(out["kernel"]["logits"], out["plain"]["logits"])
    out["max_abs_err"], out["rel_err"] = err, rel
    out["finite"] = bool(torch.isfinite(out["kernel"]["logits"]).all()
                         & torch.isfinite(out["plain"]["logits"]).all())
    return out


def check_routes(tag: str, res: dict, expect: int, tc: bool,
                 limit: "float | None") -> None:
    """Launch counts of both routes; the logits finite and, unless
    ``limit`` is None (an MoE model in bf16), within ``limit``."""
    k, p = res["kernel"]["launches"], res["plain"]["launches"]
    if (k["flash"] != expect or k["flash_tc"] != (expect if tc else 0)
            or p["flash"] != 0):
        fail(f"{tag}: flash launches {k['flash']} on the kernel forward "
             f"({k['flash_tc']} on the tensor cores; expected {expect}), "
             f"{p['flash']} on the plain one (expected 0)")
    if not (res["finite"] and (limit is None or res["rel_err"] <= limit)):
        fail(f"{tag}: kernel vs plain last-token logits rel "
             f"{res['rel_err']:.3e} ({limit_text(limit)}), finite "
             f"{res['finite']}")


def limit_text(limit: "float | None") -> str:
    return ("reported: MoE routing in bf16" if limit is None
            else f"limit {limit:.1e}")


def routed_f32_check(cfg, params, batch, card: str) -> dict:
    """An MoE model's kernel vs plain route in f32 (the FFMA flash kernel)
    on its first F32_CUT_LAYERS layers, the bf16 weights cast up."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.models.build import make_model
    cut = dataclasses.replace(cfg, dtype="float32", num_layers=F32_CUT_LAYERS)
    stack = {seg.kind: transformer.tree_map(
        lambda t, n=seg.count: t[:n].float(), params["stack"][seg.kind])
        for seg in transformer.arch_segments(cut)}
    p32 = {k: transformer.tree_map(lambda t: t.float(), v)
           for k, v in params.items() if k != "stack"}
    p32["stack"] = stack
    res = kernel_vs_plain(make_model(cut), p32, batch)
    tag = f"{cfg.name} f32, first {F32_CUT_LAYERS} layers"
    print(f"[10] {tag}: last-token logits kernel vs plain route rel "
          f"{res['rel_err']:.3e} (limit {F32_LOGIT_TOL:.0e}); flash "
          f"launches {res['kernel']['launches']['flash']} "
          f"({calls_text(res['kernel']['calls'])}), "
          f"{res['plain']['launches']['flash']} on the plain route; peak "
          f"memory {res['peak_gb']:.2f} GB [{card}]", flush=True)
    check_routes(tag, res, F32_CUT_LAYERS, False, F32_LOGIT_TOL)
    return {"layers": F32_CUT_LAYERS, "rel_err": res["rel_err"],
            "max_abs_err": res["max_abs_err"],
            "launches": res["kernel"]["launches"]["flash"]}


def tree_bytes(tree) -> int:
    from repro_torch.models import transformer
    leaves = []
    transformer.tree_map(leaves.append, tree)
    return sum(t.numel() * t.element_size() for t in leaves)


# each phase-10 model's last-token logits through the kernel (phase 14b
# reports the mesh forward's gap to deepseek-moe-16b's)
PHASE10_LOGITS: dict = {}


def family_phase(arch: str, prefill, decode, expect: int, card: str, dev,
                 gen) -> dict:
    """Phase 10, one model at its published widths and depth (bf16, random
    weights from a generator on the card): prefill through the flash
    kernel and the plain route, timed forwards, cached decode; for
    qwen2-7b also a batch of 32 against a 4,096-slot cache and decode
    against the forward with the weights in f32."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import transformer
    from repro_torch.models.build import make_model

    cfg = get_config(arch)
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []
    transformer.tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    print(f"[10] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv heads, "
          f"head_dim {cfg.resolved_head_dim}, {cfg.dtype}; {n_params:,} "
          f"parameters on the card ({tree_bytes(params) / 1e9:.2f} GB), "
          f"init {init_s:.2f} s", flush=True)
    out = {"parameters": n_params, "init_s": init_s}

    b, s = prefill
    batch = family_batch(cfg, b, s, dev, gen)
    res = kernel_vs_plain(model, params, batch)
    k_calls = res["kernel"]["calls"]
    limit = None if cfg.moe is not None else LOGIT_TOL
    agree = float((res["kernel"]["logits"].argmax(-1)
                   == res["plain"]["logits"].argmax(-1)).float().mean())
    print(f"[10] {arch} prefill {b} x {s}: last-token logits kernel vs "
          f"plain route max |diff| {res['max_abs_err']:.4e}, rel "
          f"{res['rel_err']:.4e} ({limit_text(limit)}), argmax agreement "
          f"{agree:.2f}; flash launches "
          f"{res['kernel']['launches']['flash']} on the kernel forward "
          f"({res['kernel']['launches']['flash_tc']} on the tensor cores: "
          f"{calls_text(k_calls)}), {res['plain']['launches']['flash']} on "
          f"the plain one; peak memory {res['peak_gb']:.2f} GB [{card}]",
          flush=True)
    check_routes(f"{arch} prefill", res, expect, True, limit)
    PHASE10_LOGITS[arch] = res["kernel"]["logits"].float().cpu()
    out.update(argmax_agreement=agree)
    if cfg.moe is not None:
        out["f32_cut"] = routed_f32_check(cfg, params, batch, card)
    out.update(launches=res["kernel"]["launches"]["flash"],
               tc_launches=res["kernel"]["launches"]["flash_tc"],
               plain_launches=res["plain"]["launches"]["flash"],
               windows=sorted({str(c[4]) for c in k_calls}),
               logits_max_abs_err=res["max_abs_err"],
               logits_rel_err=res["rel_err"], prefill_peak_gb=res["peak_gb"],
               first_forward_ms=res["kernel"]["ms"],
               plain_forward_ms=res["plain"]["ms"])
    del res

    def forward():
        model.forward(params, batch, use_kernel=True, last_only=True)
        torch.cuda.synchronize()

    with torch.inference_mode():
        before = counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward()
            times.append(1e3 * (time.perf_counter() - t0))
        wall_us, busy_us, idle, events = profiled(forward)
        reset_counts(before)            # timing launches do not count
    med = statistics.median(times)
    kinds = device_ms_by_kind(events)
    flash_kind = kinds.get(FLASH_KERNELS["flash_wgmma_kernel"])
    out.update(forward_ms=times, forward_median_ms=med,
               tokens_per_s=b * s / (med / 1e3), idle=idle,
               forward_wall_ms=wall_us / 1e3,
               forward_busy_ms=busy_us / 1e3, forward_device_ms=kinds,
               flash_ms_per_call=(flash_kind["ms"] / flash_kind["events"]
                                  if flash_kind else None))
    print(f"[10] {arch} prefill forward through the kernel: median "
          f"{med:.1f} ms of {[round(t, 1) for t in times]} = "
          f"{out['tokens_per_s']:,.0f} tokens/s; plain forward "
          f"{out['plain_forward_ms']:.1f} ms (one call); profiled forward: "
          f"wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, "
          f"idle share {idle}; device ms by kind {json.dumps(kinds)} "
          f"[{card}]", flush=True)

    b, steps = decode
    toks = next(synthetic_token_batches(cfg.vocab_size, b, steps, seed=0))
    tokens = torch.as_tensor(toks["tokens"], device=dev)
    with torch.inference_mode():
        reset_counts()
        dec_logits, step_ms = decode_run(model, params, tokens)
        caches = model.init_cache(b, steps, device=dev)
        d_wall, d_busy, d_idle, d_events = profiled(
            lambda: model.decode_step(params, caches, tokens[:, :1]))
        dec_launches = counts()["flash"]
    del caches
    n_dev = sum(1 for e in d_events if e.device_type == DeviceType.CUDA)
    ordered = sorted(step_ms[1:])
    out.update(decode_step_ms=step_ms,
               decode_median_ms=statistics.median(step_ms[1:]),
               decode_p90_ms=ordered[int(0.9 * (len(ordered) - 1))],
               decode_flash_launches=dec_launches,
               decode_profiled={"wall_ms": d_wall / 1e3,
                                "busy_ms": d_busy / 1e3, "idle": d_idle,
                                "device_events": n_dev})
    print(f"[10] {arch} decode {b} requests x {steps} tokens "
          f"(init_cache({b}, {steps}), one decode_step per token): per "
          f"token median {out['decode_median_ms']:.2f} ms, p90 "
          f"{out['decode_p90_ms']:.2f} ms, first {step_ms[0]:.2f} ms = "
          f"{b * 1e3 / out['decode_median_ms']:,.0f} tokens/s; flash "
          f"launches {dec_launches} (decode is plain torch); profiled step: "
          f"wall {d_wall / 1e3:.2f} ms, device busy {d_busy / 1e3:.2f} ms, "
          f"idle share {d_idle}, {n_dev} device events [{card}]", flush=True)
    if not bool(torch.isfinite(dec_logits).all()) or dec_launches:
        fail(f"{arch} decode: logits not finite or the flash kernel "
             f"launched ({dec_launches})")
    del dec_logits

    if arch == "qwen2-7b":
        bb, max_len, n_steps = BATCH_DECODE
        toks = next(synthetic_token_batches(cfg.vocab_size, bb, n_steps,
                                            seed=1))
        many = torch.as_tensor(toks["tokens"], device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            caches = model.init_cache(bb, max_len, device=dev)
            cache_gb = tree_bytes(caches) / 1e9
            ms = []
            for t in range(n_steps):
                t0 = time.perf_counter()
                logits, caches = model.decode_step(params, caches,
                                                   many[:, t:t + 1])
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            finite = bool(torch.isfinite(logits).all())
        del caches, logits
        batch_med = statistics.median(ms[1:])
        out["batch_decode"] = {
            "batch": bb, "max_len": max_len, "steps": n_steps,
            "cache_gb": cache_gb, "step_ms": ms,
            "median_step_ms": batch_med,
            "tokens_per_s": bb * 1e3 / batch_med,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[10] {arch} decode batch {bb} against init_cache({bb}, "
              f"{max_len}) ({cache_gb:.2f} GB of KV cache; decode_32k's "
              f"batch of 128 would need {4 * cache_gb * 32768 / max_len:.0f} "
              f"GB, not attempted): {n_steps} steps, median "
              f"{batch_med:.2f} ms a step = "
              f"{out['batch_decode']['tokens_per_s']:,.0f} tokens/s, first "
              f"{ms[0]:.2f} ms; peak memory "
              f"{out['batch_decode']['peak_gb']:.2f} GB [{card}]", flush=True)
        if not finite:
            fail(f"{arch} batch decode: logits not finite")

        # decode against the kernel forward (the FFMA flash route) in f32
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = make_model(cfg32)
        params32 = transformer.tree_map(lambda t: t.float(), params)
        with torch.inference_mode():
            reset_counts()
            dec32, _ = decode_run(model32, params32, tokens)
            full32, _, _ = model32.forward(params32, {"tokens": tokens},
                                           use_kernel=True)
            f32_launches = counts()
        torch.cuda.synchronize()
        gap32, ok32 = probs_gap(dec32, full32)
        _, rel32 = rel_err(dec32, full32)
        out.update(decode_f32_max_abs_dp=gap32, decode_f32_logits_rel=rel32,
                   decode_f32_flash_launches=f32_launches["flash"])
        print(f"[10] {arch} decode vs the kernel forward over the same "
              f"{steps} tokens, f32 weights at full depth (no cut; "
              f"{f32_launches['flash']} FFMA flash launches, "
              f"{f32_launches['flash_tc']} on the tensor cores): max |dp| "
              f"{gap32:.3e}, allclose rtol {DECODE_RTOL} atol {DECODE_ATOL}: "
              f"{'ok' if ok32 else 'FAIL'}; logits rel {rel32:.3e} "
              f"(reported)", flush=True)
        if not (ok32 and f32_launches["flash"] == cfg.num_layers
                and f32_launches["flash_tc"] == 0):
            fail(f"{arch}: f32 decode disagrees with the kernel forward "
                 f"(max |dp| {gap32:.3e}) or the FFMA route did not run")
        del params32, model32, dec32, full32
    del params, batch, tokens
    torch.cuda.empty_cache()
    return out


def reduced_families_phase(card: str, dev, gen) -> dict:
    """Phase 10, the other families at their reduced configurations on the
    card: kernel route vs plain route in f32 and bf16."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.build import make_model
    out = {}
    b, s = REDUCED_SEQ
    for arch, expect in REDUCED_FAMILIES:
        for dtype, limit in (("float32", F32_LOGIT_TOL),
                             ("bfloat16", LOGIT_TOL)):
            cfg = dataclasses.replace(get_config(arch, reduced=True),
                                      dtype=dtype)
            if cfg.moe is not None and dtype == "bfloat16":
                limit = None
            model = make_model(cfg)
            params = model.init(seed=0, device=dev)
            batch = family_batch(cfg, b, s, dev, gen)
            res = kernel_vs_plain(model, params, batch)
            tc = dtype == "bfloat16"
            tag = f"{arch} reduced {dtype}"
            print(f"[10] {tag} ({b} x {s} positions): last-token logits "
                  f"kernel vs plain rel {res['rel_err']:.3e} "
                  f"({limit_text(limit)}); flash launches "
                  f"{res['kernel']['launches']['flash']} "
                  f"({calls_text(res['kernel']['calls'])}), "
                  f"{res['plain']['launches']['flash']} on the plain route",
                  flush=True)
            check_routes(tag, res, expect, tc, limit)
            out[f"{arch} {dtype}"] = {
                "launches": res["kernel"]["launches"]["flash"],
                "rel_err": res["rel_err"],
                "max_abs_err": res["max_abs_err"]}
            del model, params, batch, res
    torch.cuda.empty_cache()
    return out


def families_phase(card: str, dev) -> dict:
    """Phase 10: the attention families through the flash kernel."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(10)
    t0 = time.perf_counter()
    out = {arch: family_phase(arch, prefill, decode, expect, card, dev, gen)
           for arch, prefill, decode, expect in FAMILIES}
    out["reduced"] = reduced_families_phase(card, dev, gen)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[10] attention families phase {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# language-model training: Model.train_step (Adam, gradient accumulation,
# remat) and the paper's layerwise ADMM, gemma-2b at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH = (4, 4096)        # train_4k cut in batch only: 256 -> 4
TRAIN_STEPS = 4                # through launch/train.py: 1 warm-up + 3 timed
FIXED_STEPS = 4                # on one fixed batch: the loss must fall
ADMM_BATCH = (4, 512)
ADMM_ITERS = 3
# reduced f32 card vs CPU: (arch, layerwise iterations before the one
# compared).  A line search decides on objective differences of
# backtrack_rtol (1e-6 relative) where the objective itself carries ~1e-5
# relative rounding noise between two machines, so a state is chosen at
# which no search of the compared iteration sits on a tie
TRAIN_REDUCED = (("gemma-2b", 2), ("deepseek-moe-16b", 4))
REDUCED_BATCH = (4, 64)
# card vs CPU: each step's delta within 1e-5 · max |delta| of the leaf
# (beside one f32 spacing of the new value: p + delta is rounded on each
# side), loss within 1e-5 relative; one layerwise iteration's tensors
# within 1e-4 · max, every tau and theta equal
GRAD_TOL = 1e-5
LW_TOL = 1e-4


def step_gap(p, new_a, new_b) -> float:
    """Worst leaf of max |new_a − new_b| − spacing(new_b), over max |new_b −
    p|: the two steps' deltas compared, less the rounding of p + delta."""
    import numpy as np

    from repro_torch.util import tree
    worst = 0.0
    for p0, a, b in zip(tree.leaves(p), tree.leaves(new_a),
                        tree.leaves(new_b)):
        p0, a, b = (t.detach().float().cpu().double().numpy()
                    for t in (p0, a, b))
        scale = float(np.abs(b - p0).max())
        slack = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
        over = float(np.max(np.abs(a - b) - slack))
        if scale > 0:
            worst = max(worst, over / scale)
    return worst


def tensors_gap(a, b) -> float:
    """Worst leaf of max |a − b| over max |b|."""
    from repro_torch.util import tree
    worst = 0.0
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        worst = max(worst, rel_err(x.detach().cpu(), y.detach().cpu())[1])
    return worst


def reduced_training_check(arch: str, n_before: int, card: str, dev) -> dict:
    """Phase 11a: the reduced f32 config on the card against the CPU from
    the same weights: one train_step (SGD, lr 1, grad_accum 2) and one
    layerwise ADMM iteration from the state after ``n_before``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.layerwise import LayerwiseADMMTrainer
    from repro_torch.core.subproblems import ADMMConfig
    from repro_torch.models.build import make_model
    from repro_torch.util import tree

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              optimizer="sgd", learning_rate=1.0,
                              grad_accum=2)
    model = make_model(cfg)
    rng = np.random.default_rng(0)
    b, s = REDUCED_BATCH
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "targets")}
    p_cpu = model.init(seed=0, device="cpu")
    p_card = tree.tree_map(lambda t: t.to(dev), p_cpu)
    new_cpu, _, m_cpu = model.train_step(p_cpu, (), batch)
    new_card, _, m_card = model.train_step(p_card, (), batch)
    grad = step_gap(p_cpu, new_card, new_cpu)
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / \
        abs(float(m_cpu["loss"]))

    tr = LayerwiseADMMTrainer(cfg, ADMMConfig(nu=1e-2, rho=1e-2))
    st, z0 = tr.init(0, batch, "cpu")
    for _ in range(n_before):
        st = tr.iteration(st, z0, batch["targets"])
    st_card = tree.tree_map(lambda t: t.to(dev), st)
    nxt_cpu = tr.iteration(st, z0, batch["targets"])
    nxt_card = tr.iteration(st_card, z0.to(dev), batch["targets"])
    curv = all(torch.equal(x.cpu(), y) for f in ("taus", "thetas", "tau_r")
               for x, y in zip(tree.leaves(getattr(nxt_card, f)),
                               tree.leaves(getattr(nxt_cpu, f))))
    lw = max(tensors_gap(getattr(nxt_card, f), getattr(nxt_cpu, f))
             for f in ("stack", "readout", "zs", "u"))
    ok = grad <= GRAD_TOL and loss_rel <= GRAD_TOL and curv and lw <= LW_TOL
    print(f"[11] {arch} reduced f32, card vs CPU: train_step (SGD lr 1, "
          f"grad_accum 2) delta rel {grad:.3e}, loss rel {loss_rel:.3e} "
          f"(limits {GRAD_TOL:g}); layerwise iteration {n_before + 1}: "
          f"tau/theta equal {curv}, tensors rel {lw:.3e} (limit "
          f"{LW_TOL:g}) {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        fail(f"{arch} training on the card disagrees with the CPU")
    return {"delta_rel": grad, "loss_rel": loss_rel, "curvatures_equal": curv,
            "layerwise_rel": lw}


def gemm_ms_by_name(events, top: int = 6) -> dict:
    """Device ms and events of the ``top`` cuBLAS kernels by name (the name
    says the operand type: bf16 on the tensor cores, or f32)."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    for e in events:
        low = e.name.lower()
        if e.device_type == DeviceType.CUDA and any(
                t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
    names = sorted(by_name, key=lambda k: -by_name[k][0])[:top]
    return {k[:90]: {"ms": round(by_name[k][0], 3), "events": by_name[k][1]}
            for k in names}


def eval_loss(model, params, batch) -> float:
    """The train step's loss at ``params`` (mean over its microbatches),
    without gradients."""
    import torch
    with torch.no_grad():
        micro = model._micro(batch, model.cfg.grad_accum)
        return sum(float(model.loss(params, mb)[0]) for mb in micro) / \
            len(micro)


def training_phase(card: str, dev, peak_bf16: float) -> dict:
    """Phase 11: reduced card vs CPU; gemma-2b at its published widths and
    depth through launch/train.py (Adam, grad_accum 4, remat) and on one
    fixed batch; layerwise ADMM on gemma-2b at full width; no kernel
    launched."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import layerwise
    from repro_torch.core.subproblems import ADMMConfig
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import train as train_launcher
    from repro_torch.util import tree

    t_phase = time.perf_counter()
    before = counts()
    out: dict = {"reduced": {arch: reduced_training_check(arch, n, card, dev)
                             for arch, n in TRAIN_REDUCED}}

    # ---- 11b. gemma-2b at full width: the launcher's loop ----
    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train_launcher.main(["--arch", TRAIN_ARCH, "--steps",
                               str(TRAIN_STEPS), "--batch", str(b), "--seq",
                               str(s), "--log-every", "1"])
    model, params, opt_state = run["model"], run["params"], run["opt_state"]
    n_params = sum(t.numel() for t in tree.leaves(params))
    timed = run["step_s"][1:]
    step_ms = 1e3 * statistics.median(timed)
    tokens = b * s
    mfu = 6.0 * n_params * tokens / (step_ms / 1e3 * peak_bf16)
    print(f"[11] {TRAIN_ARCH}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"{cfg.resolved_head_dim}, {cfg.mlp} {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params:,} parameters; "
          f"{cfg.optimizer}, grad_accum {cfg.grad_accum}, remat {cfg.remat}; "
          f"batch {b} x {s} [{card}]", flush=True)
    print(f"[11] launcher steps (pipeline batches): "
          f"{[round(1e3 * t, 1) for t in run['step_s']]} ms, losses "
          f"{[round(v, 4) for v in run['losses']]}; median of the "
          f"{len(timed)} after warm-up {step_ms:.1f} ms = "
          f"{tokens / step_ms * 1e3:,.0f} tokens/s; model-FLOPs share "
          f"(6 N tokens / (step time x {peak_bf16 / 1e12:g} TFLOP/s)) "
          f"{mfu:.4f}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    out["full"] = {"parameters": n_params, "step_ms": step_ms,
                   "steps_ms": [1e3 * t for t in run["step_s"]],
                   "launcher_losses": run["losses"],
                   "tokens_per_s": tokens / step_ms * 1e3, "mfu": mfu,
                   "launcher_peak_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
    del run

    fixed = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=1))
    fixed = {k: torch.as_tensor(v, device=dev) for k, v in fixed.items()}
    held = {"params": tree_bytes(params), "opt_state": tree_bytes(opt_state),
            "batch": tree_bytes(fixed)}
    gc.collect()
    losses, evals, fixed_ms = [], [], []
    for i in range(FIXED_STEPS):
        torch.cuda.synchronize()
        if i == 0:
            # phase 16 holds the dry run's peak against this step's
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt_state, m = model.train_step(params, opt_state, fixed)
        if i == 0:
            step_peak = torch.cuda.max_memory_allocated()
        losses.append(float(m["loss"]))
        fixed_ms.append(1e3 * (time.perf_counter() - t0))
        if i in (0, FIXED_STEPS - 1):
            evals.append(eval_loss(model, params, fixed))
    falls = evals[1] < evals[0]
    print(f"[11] {FIXED_STEPS} train_steps on one fixed batch: step losses "
          f"{[round(v, 4) for v in losses]}, {[round(t, 1) for t in fixed_ms]} "
          f"ms; loss after step 1 {evals[0]:.4f}, after step {FIXED_STEPS} "
          f"{evals[1]:.4f} ({'falls' if falls else 'FAIL: does not fall'}) "
          f"[{card}]", flush=True)
    if not (falls and all(math.isfinite(v) for v in losses + evals)):
        fail("gemma-2b's loss does not fall on a fixed batch")
    print(f"[11] the first fixed-batch train_step: {base:,} B allocated "
          f"before it (parameters {held['params']:,} + Adam state "
          f"{held['opt_state']:,} + batch {held['batch']:,} = "
          f"{sum(held.values()):,} B), peak {step_peak:,} B [{card}]",
          flush=True)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _ = model.train_step(params, opt_state, fixed)
    wall_us, busy_us, idle, events = profiled(one_step)
    kinds = device_ms_by_kind(events, top=6)
    gemms = gemm_ms_by_name(events)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[11] profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {idle}; device ms by kind "
          f"{json.dumps(kinds)}; the matrix products by kernel "
          f"{json.dumps(gemms)}; peak {peak:.2f} GB [{card}]", flush=True)
    out["full"].update(held_bytes=held, step_base_bytes=base,
                       step_peak_bytes=step_peak,
                       fixed_losses=losses, fixed_ms=fixed_ms,
                       loss_after_first=evals[0], loss_after_last=evals[1],
                       wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                       idle=idle, device_ms=kinds, gemm_ms=gemms,
                       peak_gb=peak)
    del params, opt_state, model, fixed, events
    torch.cuda.empty_cache()

    # ---- 11c. layerwise ADMM on gemma-2b at full width ----
    torch.cuda.reset_peak_memory_stats()
    b, s = ADMM_BATCH
    admm_batch = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=2))
    tr = layerwise.LayerwiseADMMTrainer(cfg, ADMMConfig(nu=1e-2, rho=1e-2))
    t0 = time.perf_counter()
    st, z0 = tr.init(0, admm_batch, dev)
    targets = torch.as_tensor(admm_batch["targets"], device=dev)
    ce, init_res = (float(v) for v in tr.metrics(st, z0, targets))
    print(f"[11] layerwise ADMM {TRAIN_ARCH} full width, batch {b} x {s}: "
          f"init {time.perf_counter() - t0:.1f} s, ce {ce:.4f}, init "
          f"residual {init_res:.3e} [{card}]", flush=True)
    iters = []
    for i in range(ADMM_ITERS):
        p0, s0 = layerwise.probes, layerwise.searches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tr.iteration(st, z0, targets)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        ce, res = (float(v) for v in tr.metrics(st, z0, targets))
        n_probe, n_search = layerwise.probes - p0, layerwise.searches - s0
        taus = {k: v.tolist() for k, v in st.taus.items()}
        iters.append({"ms": ms, "ce": ce, "residual": res,
                      "probes": n_probe, "searches": n_search,
                      "tau_r": float(st.tau_r), "taus": taus})
        print(f"[11] layerwise iteration {i + 1}: {ms:.1f} ms, {n_search} "
              f"line searches, {n_probe} probes ({n_probe / n_search:.1f} "
              f"host reads a search), ce {ce:.4f}, residual {res:.3e}, "
              f"tau_r {float(st.tau_r):g}, taus {taus} [{card}]", flush=True)
        if not (math.isfinite(ce) and math.isfinite(res)):
            fail("layerwise ADMM gave a non-finite CE or residual")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[11] layerwise ADMM peak {peak:.2f} GB [{card}]", flush=True)
    out["layerwise"] = {"init_residual": init_res,
                        "iterations": iters, "peak_gb": peak}
    del st, z0, tr
    torch.cuda.empty_cache()

    after = counts()
    launched = {k: after[k] - before[k] for k in after}
    print(f"[11] kernel launches in the training phase: {launched} "
          f"(training runs the reference's plain route: no kernel has a "
          f"backward pass) [{card}]", flush=True)
    if any(launched.values()):
        fail("the training phase launched a kernel")
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[11] training phase {out['phase_s']:.1f} s; summary "
          f"{json.dumps(out)}", flush=True)
    return out


ANALYSIS_TRAINERS = (("1 shard, packed ELL", 1, {}),
                     (f"{SHARDS} shards, packed", SHARDS, {}),
                     (f"{SHARDS} shards, fused", SHARDS, {"fused": True}))


def analysis_phase(cfg, admm, g, card: str, dev) -> dict:
    """Phase 12: the invariant linter on the card, on the kernel route:
    launch/analyze.py's full config set and both serving paths at the
    CLI's size, then one recorded step of each full-width trainer of
    phases 3 and 3m.  Prints every finding (the waived ones too); fails on
    an error finding, a kernel event off the CUDA route, or a launch spec
    over the card's shared memory or unequal to its CUDA layout query."""
    import torch

    from repro_torch import analysis
    from repro_torch.analysis.registry import AnalysisContext
    from repro_torch.analysis.rules.kernel import kernel_entries, smem_limit
    from repro_torch.core import graph
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.kernels import community_spmm
    from repro_torch.launch import analyze

    t0 = time.perf_counter()
    waivers = analyze.waivers()
    specs: dict = {}
    out: dict = {}

    def lint(name: str, tape, exp: dict) -> None:
        ctx = AnalysisContext(trace=tape, expectations=exp, config=name)
        rep = analysis.run_rules(ctx, waivers=waivers)
        for spec, _ in kernel_entries(ctx):
            specs.setdefault(spec, name)
        kernels = collections.Counter(
            (e.name, e.info["route"]) for e in tape.of_kind("kernel"))
        transports = collections.Counter(
            e.kind for e in tape if e.kind not in ("op", "kernel"))
        head, *lines = rep.summary().splitlines()
        print(f"[12] {head}; {len(tape)} events, kernels "
              f"{json.dumps({f'{k} ({r})': v for (k, r), v in kernels.items()})}"
              f", transport {json.dumps(dict(transports))}", flush=True)
        for line in lines + [f"  waived: {f}" for f in rep.waived]:
            print(f"[12] {line}", flush=True)
        off_card = [k for k, r in kernels if r != "cuda"]
        if rep.errors() or off_card:
            fail(f"analysis of {name}: {len(rep.errors())} error "
                 f"finding(s), kernels off the card {off_card}")
        out[name] = {"errors": 0, "warnings": len(rep.warnings()),
                     "waived": [f.rule for f in rep.waived],
                     "events": len(tape), "kernels": sum(kernels.values())}

    for spec in analyze.FULL_CONFIGS:
        tape, exp = analysis.record_step(analyze.build_trainer(spec, dev))
        lint(spec["name"], tape, exp)
    srv = analyze.build_server(dev)
    lint("serve_hit", srv.hit_path_trace(bucket=64),
         {"expect_zero_collectives": True,
          "full_graph_rows": int(srv.dl.plane_rows)})
    lint("serve_halo", srv.halo_path_trace(layer=1),
         {"expect_zero_collectives": True})
    del srv
    t_cli = time.perf_counter() - t0

    part = graph.partition_graph(g.num_nodes, g.edges, 3, seed=0,
                                 method="bfs_kl")
    for name, n_shards, kw in ANALYSIS_TRAINERS:
        tr = ParallelADMMTrainer(
            cfg, admm, g, num_parts=3, seed=0, part=part, device=dev,
            n_shards=n_shards,
            config=TrainerConfig.packed(use_kernel=True,
                                        partitioner="bfs_kl", **kw))
        tape, exp = analysis.record_step(tr)
        lint(f"full width {cfg.layer_dims}, M=3, {name}", tape, exp)
        del tr, tape, exp
        torch.cuda.empty_cache()

    limit = smem_limit()
    bad = []
    for spec, where in specs.items():
        words = community_spmm.query_layout(spec)
        ok = words == spec.layout_words() and spec.smem_bytes <= limit
        print(f"[12] spec {spec.name} {spec.symbol} grid {spec.grid} x "
              f"{spec.threads} threads, cluster {spec.cluster}, smem "
              f"{spec.smem_bytes} B (limit {limit}), copies "
              f"{[(a.name, a.copy_bytes) for a in spec.args if a.copy_bytes]}"
              f" ({where}): layout query {list(words)} "
              f"{'= spec' if ok else '!= spec ' + str(spec.layout_words())}",
              flush=True)
        if not ok:
            bad.append(spec.name)
    if bad:
        fail(f"launch specs disagree with the card: {bad}")
    secs = time.perf_counter() - t0
    print(f"[12] analysis phase {secs:.1f} s (CLI configs {t_cli:.1f} s): "
          f"{len(out)} runs, 0 error findings, {len(specs)} distinct launch "
          f"specs, all equal to their layout queries and within {limit} B "
          f"[{card}]", flush=True)
    return {"seconds": secs, "runs": out, "specs": len(specs)}


# ---------------------------------------------------------------------------
# the language models over a data × model mesh of rank processes
# ---------------------------------------------------------------------------

MESH_TRAIN_ARCH = "mamba2-1.3b"
MESH_TRAIN_BATCH = (4, 4096)   # global batch; 2 sequences a data rank
MESH_TRAIN_STEPS = 3           # 1 warm-up + 2 timed
MESH_TRAIN_LAYERS = 24         # of mamba2-1.3b's 48, for the script's time
MESH_DP = 2                    # [13a]: data 2
MESH_LW = (2, 2)               # [13b]: data 2 × model 2
MESH_LW_ITERS = 2


def tree_hash(tree_) -> str:
    """sha256 of every leaf's bits (on the host)."""
    import hashlib

    import torch

    from repro_torch.util import tree
    h = hashlib.sha256()
    for leaf in tree.leaves(tree_):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_train_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 13a, one of 2 data ranks (gloo, the one card): the reduced f32
    gemma-2b deferred step from the parent's weights on this rank's rows,
    then mamba2-1.3b at full width, 1 + 2 steps of train_step_deferred on
    its rows of each pipeline batch; its record to ``spec["dir"]``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.messages import MeshCollectives
    from repro_torch.data import TokenPipeline, synthetic_token_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.util import tree
    base = mesh_lib.init_process_mesh(rank, MESH_DP, "gloo", store,
                                      timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, 1)
        dev = mesh.device
        out_dir = pathlib.Path(spec["dir"])
        rec: dict = {"device": str(dev)}
        # -- reduced f32 gemma-2b against one process (the parent's) --
        cfg = dataclasses.replace(get_config("gemma-2b", reduced=True),
                                  optimizer="sgd", learning_rate=1.0,
                                  grad_accum=2)
        model = make_model(cfg)
        with np.load(out_dir / "reduced-init.npz") as data:
            leaves = [torch.from_numpy(data[f"arr_{i}"]).to(dev)
                      for i in range(len(data.files))]
        params = tree.unflatten(model.init(0, "cpu"), leaves)
        with np.load(out_dir / "reduced-batch.npz") as data:
            batch = {k: data[k] for k in data.files}
        rows = mesh_lib.batch_rows(mesh, len(batch["tokens"]))
        new, _, met = model.train_step_deferred(
            mesh, params, (), {k: v[rows] for k, v in batch.items()})
        np.savez(out_dir / f"reduced-rank{rank}.npz",
                 *[t.cpu().numpy() for t in tree.leaves(new)])
        rec["reduced"] = {"loss": float(met["loss"]), "hash": tree_hash(new)}
        del model, params, new
        # -- mamba2-1.3b at full width --
        cfg = dataclasses.replace(get_config(MESH_TRAIN_ARCH),
                                  num_layers=MESH_TRAIN_LAYERS)
        model = make_model(cfg)
        b, s = MESH_TRAIN_BATCH
        pipeline = TokenPipeline(
            synthetic_token_batches(cfg.vocab_size, b, s, seed=3),
            mesh=mesh)
        params = model.init(seed=0, device=dev)
        opt_state = model.init_optimizer().init(params)
        comm = MeshCollectives(mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        steps = []
        for _ in range(MESH_TRAIN_STEPS):
            batch = next(pipeline)
            before = (comm.sum_bytes, comm.sum_s, comm.staging_s)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt_state, met = model.train_step_deferred(
                mesh, params, opt_state, batch, comm=comm)
            loss = float(met["loss"])
            ms = 1e3 * (time.perf_counter() - t0)
            steps.append({"ms": ms, "loss": loss,
                          "rows": int(batch["tokens"].shape[0]),
                          "sum_bytes": comm.sum_bytes - before[0],
                          "sum_ms": 1e3 * (comm.sum_s - before[1]),
                          "staging_ms": 1e3 * (comm.staging_s - before[2]),
                          "hash": tree_hash(params)})
        rec["full"] = {"steps": steps,
                       "parameters": sum(t.numel()
                                         for t in tree.leaves(params)),
                       "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        rec["launches"] = counts()
        (out_dir / f"train-rank{rank}.json").write_text(json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def mesh_layerwise_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 13b, one of 2 × 2 ranks (data × model; gloo, the one card):
    one layerwise iteration of the reduced f32 gemma-2b from the parent's
    one-process state, then gemma-2b at full width — init (the pipelined
    forward) and 2 iterations; its record to ``spec["dir"]``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import layerwise
    from repro_torch.core.subproblems import ADMMConfig
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.util import tree
    base = mesh_lib.init_process_mesh(rank, math.prod(MESH_LW), "gloo",
                                      store, timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, MESH_LW[1])
        dev = mesh.device
        out_dir = pathlib.Path(spec["dir"])
        admm = ADMMConfig(nu=1e-2, rho=1e-2)
        rec: dict = {"device": str(dev), "coords": mesh.coords}
        # -- reduced f32 gemma-2b against one process (the parent's) --
        cfg = get_config("gemma-2b", reduced=True)
        with np.load(out_dir / "lw-batch.npz") as data:
            batch = {k: data[k] for k in data.files}
        one = layerwise.LayerwiseADMMTrainer(cfg, admm)
        like, _ = one.init(0, batch, "cpu")
        with np.load(out_dir / "lw-state.npz") as data:
            arrays = [torch.from_numpy(data[f"arr_{i}"])
                      for i in range(len(data.files))]
        tr = layerwise.LayerwiseADMMTrainer(cfg, admm, mesh=mesh)
        local, z0 = tr.shard_state(tree.unflatten(like, arrays[:-1]),
                                   arrays[-1])
        nxt = tr.iteration(local, z0, batch["targets"])
        parts = {}
        for seg, lo, hi, _ in tr.local:
            for i, leaf in enumerate(tree.leaves(nxt.stack[seg.kind])):
                parts[f"stack/{seg.kind}/{i}"] = leaf.cpu().numpy()
            for f in ("zs", "taus", "thetas"):
                parts[f"{f}/{seg.kind}"] = getattr(nxt, f)[seg.kind] \
                    .cpu().numpy()
        if tr._last:
            for i, leaf in enumerate(tree.leaves(nxt.readout)):
                parts[f"readout/{i}"] = leaf.cpu().numpy()
            parts["u"] = nxt.u.cpu().numpy()
            parts["tau_r"] = nxt.tau_r.cpu().numpy()
        np.savez(out_dir / f"lw-rank{rank}.npz", **parts)
        rec["reduced"] = {"local": [[s.kind, lo, hi]
                                    for s, lo, hi, _ in tr.local],
                          "rows": [tr._rows.start, tr._rows.stop],
                          "last": tr._last}
        del tr, local, nxt, one, like
        # -- gemma-2b at full width --
        cfg = get_config(TRAIN_ARCH)
        b, s = ADMM_BATCH
        admm_batch = next(synthetic_token_batches(cfg.vocab_size, b, s,
                                                  seed=2))
        torch.cuda.reset_peak_memory_stats(dev)
        tr = layerwise.LayerwiseADMMTrainer(cfg, admm, mesh=mesh)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        st, z0 = tr.init(0, admm_batch)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        ce0, res0 = (float(v) for v in tr.metrics(st, z0,
                                                  admm_batch["targets"]))
        iters = []
        for _ in range(MESH_LW_ITERS):
            p0, s0 = layerwise.probes, layerwise.searches
            c0 = (tr.comm.sum_bytes, tr.comm.sent_bytes, tr.comm.sum_s,
                  tr.comm.shift_s, tr.comm.staging_s)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            st = tr.iteration(st, z0, admm_batch["targets"])
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            ce, res = (float(v) for v in tr.metrics(st, z0,
                                                    admm_batch["targets"]))
            iters.append({
                "ms": ms, "ce": ce, "residual": res,
                "probes": layerwise.probes - p0,
                "searches": layerwise.searches - s0,
                "sum_bytes": tr.comm.sum_bytes - c0[0],
                "sent_bytes": tr.comm.sent_bytes - c0[1],
                "sum_ms": 1e3 * (tr.comm.sum_s - c0[2]),
                "shift_ms": 1e3 * (tr.comm.shift_s - c0[3]),
                "staging_ms": 1e3 * (tr.comm.staging_s - c0[4]),
                "w_hash": tree_hash(st.stack)})
        rec["full"] = {"init_s": init_s, "ce0": ce0, "residual0": res0,
                       "iterations": iters,
                       "blocks": [[s.kind, lo, hi]
                                  for s, lo, hi, _ in tr.local],
                       "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        rec["launches"] = counts()
        (out_dir / f"lw-rank{rank}.json").write_text(json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def mesh_phase(card: str, dev) -> dict:
    """Phase 13: the language models over a data × model mesh of rank
    processes sharing the one card (gloo: NCCL refuses two ranks on one
    card).  13a: 2 data ranks running Model.train_step_deferred — the
    reduced f32 gemma-2b against one process's step on the whole batch
    (GRAD_TOL), then mamba2-1.3b at its published widths and depth (Adam,
    grad_accum 2, remat, bf16) on 4 x 4,096 tokens a step, 2 sequences a
    rank: step ms, tokens/s, peak GB a rank, the bytes reduced a step and
    the host ms of the reduction and its staging, parameter hashes equal
    on both ranks after every step, the loss finite.  13b: 2 x 2 ranks
    running LayerwiseADMMTrainer(mesh=...) (blocks over model, rows over
    data) — the reduced f32 gemma-2b iteration from the one-process state
    after 2 against one process (tau/theta equal, LW_TOL), then gemma-2b at
    full width on 4 x 512 tokens, init and 2 iterations: ms an iteration,
    peak GB a rank, bytes summed over data and sent along model, probes a
    search, W hashes equal on the data ranks of each model rank, the
    composed CE below its initial value, the residual finite.  No kernel
    launches (training runs the plain route)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import layerwise
    from repro_torch.core.subproblems import ADMMConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.util import tree

    t_phase = time.perf_counter()
    before = counts()
    torch.cuda.empty_cache()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mesh13_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- 13a: data-parallel train_step_deferred over 2 ranks ----
        cfg = dataclasses.replace(get_config("gemma-2b", reduced=True),
                                  optimizer="sgd", learning_rate=1.0,
                                  grad_accum=2)
        model = make_model(cfg)
        rng = np.random.default_rng(0)
        b, s = REDUCED_BATCH
        batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                 for k in ("tokens", "targets")}
        p = model.init(seed=0, device=dev)
        np.savez(tmp / "reduced-init.npz",
                 *[t.cpu().numpy() for t in tree.leaves(p)])
        np.savez(tmp / "reduced-batch.npz", **batch)
        want, _, m_one = model.train_step_deferred(None, p, (), batch)
        t0 = time.perf_counter()
        mesh_lib.run_ranks(mesh_train_rank, MESH_DP, ({"dir": str(tmp)},),
                           timeout=900)
        wall = time.perf_counter() - t0
        recs = [json.loads((tmp / f"train-rank{r}.json").read_text())
                for r in range(MESH_DP)]
        with np.load(tmp / "reduced-rank0.npz") as data:
            got = tree.unflatten(p, [torch.from_numpy(data[f"arr_{i}"])
                                     for i in range(len(data.files))])
        gap = step_gap(p, got, want)
        loss_rel = abs(recs[0]["reduced"]["loss"] - float(m_one["loss"])) / \
            abs(float(m_one["loss"]))
        same = len({r["reduced"]["hash"] for r in recs}) == 1
        ok = gap <= GRAD_TOL and loss_rel <= GRAD_TOL and same
        print(f"[13a] {MESH_DP} data ranks (gloo, one card) in {wall:.1f} s, "
              f"devices {[r['device'] for r in recs]}; reduced f32 gemma-2b "
              f"train_step_deferred (SGD lr 1, grad_accum 2, {b} x {s}) "
              f"against one process: delta rel {gap:.3e}, loss rel "
              f"{loss_rel:.3e} (limits {GRAD_TOL:g}), the same bits on both "
              f"ranks {same} {'ok' if ok else 'FAIL'} [{card}]", flush=True)
        if not ok:
            fail("13a: the data-parallel step disagrees with one process")
        del model, p, want
        torch.cuda.empty_cache()
        full = [r["full"] for r in recs]
        steps = [[st["ms"] for st in f["steps"]] for f in full]
        head = full[0]["steps"]
        gb, gs = MESH_TRAIN_BATCH
        timed = [max(st[i] for st in steps)
                 for i in range(1, MESH_TRAIN_STEPS)]
        step_ms = statistics.median(timed)
        print(f"[13a] {MESH_TRAIN_ARCH} full width, {MESH_TRAIN_LAYERS} "
              f"layers ({full[0]['parameters']:,} parameters, bf16, Adam, "
              f"grad_accum 2, remat), global batch "
              f"{gb} x {gs}, {head[0]['rows']} sequences a rank: step ms by "
              f"rank {[[round(t, 1) for t in st] for st in steps]}; median of "
              f"the {len(timed)} after warm-up (slowest rank) {step_ms:.1f} ms "
              f"= {gb * gs / step_ms * 1e3:,.0f} tokens/s; losses "
              f"{[round(st['loss'], 4) for st in head]}; peak "
              f"{[round(f['peak_gb'], 2) for f in full]} GB a rank "
              f"[{card}]", flush=True)
        print(f"[13a] the deferred reduction a step: "
              f"{[st['sum_bytes'] for st in head]} B summed over "
              f"{MESH_DP} data ranks (rank 0), host ms in it by rank "
              f"{[[round(st['sum_ms'], 1) for st in f['steps']] for f in full]}"
              f", of it staging "
              f"{[[round(st['staging_ms'], 1) for st in f['steps']] for f in full]}"
              f"; parameter hashes equal after every step "
              f"{[len({f['steps'][i]['hash'] for f in full}) == 1 for i in range(MESH_TRAIN_STEPS)]}"
              f" [{card}]", flush=True)
        for i in range(MESH_TRAIN_STEPS):
            if len({f["steps"][i]["hash"] for f in full}) != 1:
                fail(f"13a: the ranks' parameters differ after step {i}")
            if not all(math.isfinite(f["steps"][i]["loss"]) for f in full):
                fail("13a: a non-finite loss")
        launched = [r["launches"] for r in recs]
        out["train"] = {"wall_s": wall, "reduced_delta_rel": gap,
                        "reduced_loss_rel": loss_rel,
                        "step_ms": step_ms, "steps_ms": steps,
                        "tokens_per_s": gb * gs / step_ms * 1e3,
                        "losses": [st["loss"] for st in head],
                        "peak_gb": [f["peak_gb"] for f in full],
                        "sum_bytes": [st["sum_bytes"] for st in head],
                        "sum_ms": [[st["sum_ms"] for st in f["steps"]]
                                   for f in full],
                        "staging_ms": [[st["staging_ms"]
                                        for st in f["steps"]]
                                       for f in full]}

        # ---- 13b: layerwise ADMM over 2 x 2 ranks ----
        admm = ADMMConfig(nu=1e-2, rho=1e-2)
        tr = layerwise.LayerwiseADMMTrainer(get_config("gemma-2b",
                                                       reduced=True), admm)
        batch = {k: rng.integers(0, tr.cfg.vocab_size, (b, s))
                 .astype(np.int32) for k in ("tokens", "targets")}
        st, z0 = tr.init(0, batch, dev)
        for _ in range(2):
            st = tr.iteration(st, z0, batch["targets"])
        np.savez(tmp / "lw-state.npz",
                 *[t.cpu().numpy() for t in tree.leaves(st) + [z0]])
        np.savez(tmp / "lw-batch.npz", **batch)
        want = tr.iteration(st, z0, batch["targets"])
        world = math.prod(MESH_LW)
        t0 = time.perf_counter()
        mesh_lib.run_ranks(mesh_layerwise_rank, world, ({"dir": str(tmp)},),
                           timeout=900)
        wall = time.perf_counter() - t0
        recs = [json.loads((tmp / f"lw-rank{r}.json").read_text())
                for r in range(world)]
        worst, curv = 0.0, True
        for r, rec in enumerate(recs):
            with np.load(tmp / f"lw-rank{r}.npz") as data:
                parts = {k: data[k] for k in data.files}
            r0, r1 = rec["reduced"]["rows"]
            for kind, lo, hi in rec["reduced"]["local"]:
                for f in ("taus", "thetas"):
                    curv &= bool(np.array_equal(
                        parts[f"{f}/{kind}"],
                        getattr(want, f)[kind][lo:hi].cpu().numpy()))
                for i, w in enumerate(tree.leaves(want.stack[kind])):
                    worst = max(worst, rel_err(
                        torch.from_numpy(parts[f"stack/{kind}/{i}"]),
                        w[lo:hi].cpu())[1])
                worst = max(worst, rel_err(
                    torch.from_numpy(parts[f"zs/{kind}"]),
                    want.zs[kind][lo:hi, r0:r1].cpu())[1])
            if rec["reduced"]["last"]:
                curv &= float(parts["tau_r"]) == float(want.tau_r)
                for i, w in enumerate(tree.leaves(want.readout)):
                    worst = max(worst, rel_err(
                        torch.from_numpy(parts[f"readout/{i}"]),
                        w.cpu())[1])
                worst = max(worst, rel_err(torch.from_numpy(parts["u"]),
                                           want.u[r0:r1].cpu())[1])
        ok = curv and worst <= LW_TOL
        print(f"[13b] {MESH_LW[0]} x {MESH_LW[1]} ranks (data x model; gloo, "
              f"one card) in {wall:.1f} s; reduced f32 gemma-2b, one "
              f"iteration from the one-process state after 2 against one "
              f"process: tau/theta equal {curv}, tensors rel {worst:.3e} "
              f"(limit {LW_TOL:g}) {'ok' if ok else 'FAIL'} [{card}]",
              flush=True)
        if not ok:
            fail("13b: the layerwise iteration over ranks disagrees with one "
                 "process")
        del tr, st, z0, want
        torch.cuda.empty_cache()
        full = [r["full"] for r in recs]
        head = full[-1]                 # the last model rank holds the CE
        print(f"[13b] {TRAIN_ARCH} full width, batch {ADMM_BATCH[0]} x "
              f"{ADMM_BATCH[1]}: blocks by rank "
              f"{[f['blocks'] for f in full]}, init (pipelined forward) "
              f"{[round(f['init_s'], 1) for f in full]} s, ce "
              f"{head['ce0']:.4f}, residual {head['residual0']:.3e}; peak "
              f"{[round(f['peak_gb'], 2) for f in full]} GB a rank [{card}]",
              flush=True)
        ce_prev = head["ce0"]
        for i in range(MESH_LW_ITERS):
            its = [f["iterations"][i] for f in full]
            h = its[-1]
            print(f"[13b] iteration {i + 1}: ms by rank "
                  f"{[round(it['ms'], 1) for it in its]}, ce {h['ce']:.4f}, "
                  f"residual {h['residual']:.3e}; probes a search by rank "
                  f"{[round(it['probes'] / it['searches'], 2) for it in its]}"
                  f"; summed over data by rank "
                  f"{[it['sum_bytes'] for it in its]} B "
                  f"({[round(it['sum_ms'], 1) for it in its]} ms), sent along "
                  f"model {[it['sent_bytes'] for it in its]} B "
                  f"({[round(it['shift_ms'], 1) for it in its]} ms), staging "
                  f"{[round(it['staging_ms'], 1) for it in its]} ms [{card}]",
                  flush=True)
            for m in range(MESH_LW[1]):
                hashes = {f["iterations"][i]["w_hash"]
                          for r, f in zip(recs, full)
                          if r["coords"]["model"] == m}
                if len(hashes) != 1:
                    fail(f"13b: W differs between the data ranks of model "
                         f"rank {m} after iteration {i + 1}")
            if not (math.isfinite(h["ce"]) and math.isfinite(h["residual"])):
                fail("13b: a non-finite CE or residual")
            if any(f["iterations"][i]["ce"] != h["ce"] for f in full):
                fail("13b: the ranks report different metrics")
            ce_prev = h["ce"]
        if not ce_prev < head["ce0"]:
            fail(f"13b: the composed CE did not fall ({head['ce0']:.4f} -> "
                 f"{ce_prev:.4f})")
        print(f"[13b] W equal on the data ranks of each model rank after "
              f"every iteration; composed CE {head['ce0']:.4f} -> "
              f"{ce_prev:.4f} [{card}]", flush=True)
        launched += [r["launches"] for r in recs]
        out["layerwise"] = {"wall_s": wall, "reduced_rel": worst,
                            "reduced_curvatures_equal": curv,
                            "init_s": [f["init_s"] for f in full],
                            "ce0": head["ce0"],
                            "iterations": [f["iterations"] for f in full],
                            "peak_gb": [f["peak_gb"] for f in full]}
    after = counts()
    launched.append({k: after[k] - before[k] for k in after})
    print(f"[13] kernel launches by rank (13a, 13b) and in this process: "
          f"{launched} (training runs the plain route) [{card}]", flush=True)
    if any(any(c.values()) for c in launched):
        fail("13: the mesh phase launched a kernel")
    out["launches"] = launched
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[13] mesh phase {out['phase_s']:.1f} s; summary "
          f"{json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the forward paths tensor-parallel over a data x model mesh
# ---------------------------------------------------------------------------

MESH14_REDUCED = ("deepseek-moe-16b", "qwen2-7b", "gemma-2b")
MESH14_MESHES = {"2x2": 2, "1x4": 4}    # [14a], 4 ranks: name -> model axis
MESH14_SEQ = (2, 64)                    # [14a] prefill, batch x tokens
MESH14_STEPS = 4                        # [14a] decode steps
MESH14_TOL = 1e-4                       # card vs CPU, of max |logit|
MESH14_ARCH = "deepseek-moe-16b"        # [14b] at full width over 1 x 2
MESH14_RANKS = 2
MESH14_PREFILL = (2, 2048)              # phase 10's shape for the model
MESH14_DECODE = (2, 8)
MESH14_SHARE = 0.55                     # parameter bytes a rank, of one's


def mesh14_tokens(vocab: int, b: int, s: int, seed: int):
    from repro_torch.data import synthetic_token_batches
    return next(synthetic_token_batches(vocab, b, s, seed=seed))["tokens"]


def mesh14_compare(got, want) -> dict:
    """This rank's block on the card against the same block on the CPU."""
    import torch
    got = got.float().cpu()
    return {"err": float((got - want.float()).abs().max()),
            "scale": float(want.float().abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def mesh14_reduced_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 14a / 17a / 18a, one of 4 ranks (gloo, the one card) as 2 x 2
    and 1 x 4: each reduced f32 model of ``spec["archs"]`` — its prefill
    forward through its kernels (flash, SSD) and 4 decode steps (an
    encoder-decoder's memory caches random) on the card and on the CPU,
    from the same slices, the flash launches by heads on the card, and
    (a model with tokens alone) decode against the mesh forward over the
    same tokens; its record to ``spec["dir"]``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.sharding import hints
    from repro_torch.util import tree
    from repro_torch.util.device import strict_f32
    strict_f32()
    base = mesh_lib.init_process_mesh(rank, 4, "gloo", store, timeout=120)
    try:
        dev = base.device
        rec: dict = {"device": str(dev), "cases": {}}
        b, s = MESH14_SEQ
        for name, model_axis in MESH14_MESHES.items():
            mesh = mesh_lib.make_rank_mesh(base, model_axis)
            for arch in spec["archs"]:
                cfg = dataclasses.replace(get_config(arch, reduced=True),
                                          dtype="float32")
                model = make_model(cfg)
                on_card = model.init(seed=0, device=dev, mesh=mesh)
                on_cpu = tree.tree_map(lambda t: t.cpu(), on_card)
                batch = split_batch(cfg, b, s, 1, "cpu")
                steps = batch["tokens"][:, :MESH14_STEPS]
                res, outs = {}, {}
                for where, params in (("card", on_card), ("cpu", on_cpu)):
                    d = dev if where == "card" else torch.device("cpu")
                    before = counts()
                    heads0 = launch_heads()["flash"]
                    with hints.sharding_hints(mesh, moe_a2a=True), \
                            torch.inference_mode():
                        logits, _, _ = model.forward(
                            params, batch, use_kernel=True, last_only=True)
                        caches = model.init_cache(b, MESH14_STEPS, device=d,
                                                  mesh=mesh)
                        split_memory(model, caches, b, 3, mesh)
                        dec = []
                        for t in range(MESH14_STEPS):
                            lg, caches = model.decode_step(
                                params, caches, steps[:, t:t + 1])
                            dec.append(lg[:, 0])
                        whole = None if len(batch) > 1 else model.forward(
                            params, {"tokens": steps})[0]
                    after = counts()
                    outs[where] = (logits, torch.stack(dec, 1), whole)
                    for key in ("flash", "ssd"):
                        res[f"{where}_{key}"] = after[key] - before[key]
                    res[f"{where}_offset"] = (after["flash_offset"]
                                              - before["flash_offset"])
                    res[f"{where}_heads"] = {
                        h: n - heads0.get(h, 0) for h, n in
                        launch_heads()["flash"].items()
                        if n != heads0.get(h, 0)}
                card, cpu = outs["card"], outs["cpu"]
                res["prefill"] = mesh14_compare(card[0], cpu[0])
                res["decode"] = mesh14_compare(card[1], cpu[1])
                if card[2] is not None:
                    gap, ok = probs_gap(card[1], card[2])
                    res["decode_vs_forward"] = {"max_dp": gap, "ok": ok}
                rec["cases"][f"{arch} {name}"] = res
                del on_card, on_cpu, outs
        rec["launches"] = counts()
        (pathlib.Path(spec["dir"]) / f"{spec['tag']}-rank{rank}.json"
         ).write_text(json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def mesh14_full_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 14b, one of the ranks of a data x model mesh (``spec``:
    ``world``, ``model_axis``, ``backend``; 1 x 2 gloo ranks on the one
    card, or four cards over NCCL): deepseek-moe-16b at its published
    widths and depth, its slices drawn by Model.init(mesh=...); prefill
    2 x 2,048 through the flash kernel (the counts set to 0 just before
    the first forward and read just after), 3 timed forwards, decode 2 x 8
    and the mesh forward over the same 8 tokens; its record to
    ``spec["dir"]``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.sharding import hints, partition
    from repro_torch.util import tree
    from repro_torch.util.device import strict_f32
    strict_f32()
    base = mesh_lib.init_process_mesh(rank, spec["world"], spec["backend"],
                                      store, timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, spec["model_axis"])
        dev = mesh.device
        out_dir = pathlib.Path(spec["dir"])
        cfg = get_config(MESH14_ARCH)
        model = make_model(cfg)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev, mesh=mesh)
        torch.cuda.synchronize(dev)
        rec: dict = {"device": str(dev), "coords": mesh.coords,
                     "init_s": time.perf_counter() - t0}
        specs = model.param_specs(mesh)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            shapes = model.init(0, "cpu")
        local = whole = 0
        for (path, leaf), (_, held) in zip(tree.leaves_with_paths(shapes),
                                           tree.leaves_with_paths(params)):
            sp = specs
            for key in path:
                sp = sp[key]
            size = leaf.element_size()
            local += math.prod(partition.local_shape(leaf.shape, sp,
                                                     mesh)) * size
            whole += leaf.numel() * size
        rec.update(resident_bytes=tree_bytes(params), shard_bytes=local,
                   one_process_bytes=whole)
        b, s = MESH14_PREFILL
        batch = {"tokens": torch.as_tensor(
            mesh14_tokens(cfg.vocab_size, b, s, seed=0), device=dev)}
        torch.cuda.reset_peak_memory_stats(dev)
        with hints.sharding_hints(mesh, moe_a2a=True) as comm, \
                torch.inference_mode():
            def forward():
                c0 = (comm.a2a_bytes, comm.model_bytes, comm.a2a_s,
                      comm.model_s, comm.staging_s, comm.line_bytes,
                      comm.line_s)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                logits, _, _ = model.forward(params, batch, use_kernel=True,
                                             last_only=True)
                torch.cuda.synchronize(dev)
                ms = 1e3 * (time.perf_counter() - t0)
                return logits, {
                    "ms": ms, "a2a_bytes": comm.a2a_bytes - c0[0],
                    "model_bytes": comm.model_bytes - c0[1],
                    "a2a_ms": 1e3 * (comm.a2a_s - c0[2]),
                    "model_ms": 1e3 * (comm.model_s - c0[3]),
                    "staging_ms": 1e3 * (comm.staging_s - c0[4]),
                    "line_bytes": comm.line_bytes - c0[5],
                    "line_ms": 1e3 * (comm.line_s - c0[6])}
            reset_counts()
            logits, first = forward()             # the main path
            rec["launches"] = counts()
            timed = [forward()[1] for _ in range(3)]
            rec.update(first=first, timed=timed,
                       logits_finite=bool(torch.isfinite(logits).all()))
            ref_path = out_dir / "phase10-logits.npy"
            if ref_path.exists():
                ref = torch.from_numpy(np.load(ref_path))
                cols = partition.local_slice(
                    ref, partition.logits_spec(cfg, mesh, b), mesh)
                got = logits.float().cpu()
                rec["phase10_gap"] = {
                    "max_abs": float((got - cols).abs().max()),
                    "scale": float(cols.abs().max()),
                    "argmax_equal_local": bool(torch.equal(
                        got.argmax(-1), cols.argmax(-1)))}
            db, ds = MESH14_DECODE
            steps = torch.as_tensor(mesh14_tokens(cfg.vocab_size, db, ds,
                                                  seed=0), device=dev)
            caches = model.init_cache(db, ds, device=dev, mesh=mesh)
            c0 = (comm.a2a_bytes, comm.model_bytes, comm.line_bytes)
            dec, step_ms = [], []
            for t in range(ds):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                lg, caches = model.decode_step(params, caches,
                                               steps[:, t:t + 1])
                torch.cuda.synchronize(dev)
                step_ms.append(1e3 * (time.perf_counter() - t0))
                dec.append(lg[:, 0])
            dec = torch.stack(dec, 1)
            rec["decode"] = {"step_ms": step_ms,
                             "a2a_bytes": comm.a2a_bytes - c0[0],
                             "model_bytes": comm.model_bytes - c0[1],
                             "line_bytes": comm.line_bytes - c0[2],
                             "finite": bool(torch.isfinite(dec).all())}
            whole_fwd, _, _ = model.forward(params, {"tokens": steps})
            gap, ok = probs_gap(dec, whole_fwd)
            rec["decode"].update(
                vs_forward_max_dp=gap, vs_forward_allclose=ok,
                argmax_agreement=float((dec.argmax(-1)
                                        == whole_fwd.argmax(-1)).float()
                                       .mean()))
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        (out_dir / f"{spec['tag']}-rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def reduced_mesh(card: str, tmp, tag: str, kernels: dict, out: dict,
                 tol: float = MESH14_TOL) -> tuple:
    """Runs ``mesh14_reduced_rank`` over 4 ranks for the archs of
    ``kernels`` (arch -> the kernel its forward launches), prints and
    holds each case (card vs CPU logits within ``tol`` of max, decode
    consistent with the mesh forward where it is run, the arch's kernel
    launched on every rank on the card and never on the CPU) into
    ``out``; returns (records, wall seconds, worst rel)."""
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    mesh_lib.run_ranks(mesh14_reduced_rank, 4, ({
        "dir": str(tmp), "tag": f"r{tag}", "archs": list(kernels)},),
        timeout=600)
    recs = [json.loads((tmp / f"r{tag}-rank{r}.json").read_text())
            for r in range(4)]
    wall = time.perf_counter() - t0
    worst = 0.0
    for case in recs[0]["cases"]:
        kernel = kernels[case.split()[0]]
        rows = [r["cases"][case] for r in recs]
        rel = {k: max(x[k]["err"] for x in rows)
               / max(max(x[k]["scale"] for x in rows), 1e-30)
               for k in ("prefill", "decode")}
        finite = all(x[k]["finite"] for x in rows
                     for k in ("prefill", "decode"))
        checked = [x["decode_vs_forward"] for x in rows
                   if "decode_vs_forward" in x]
        consistent = all(c["ok"] for c in checked)
        dp = max((c["max_dp"] for c in checked), default=0.0)
        launched = [x[f"card_{kernel}"] for x in rows]
        offset = [x["card_offset"] for x in rows]
        ok = (max(rel.values()) <= tol and finite and consistent
              and all(f > 0 for f in launched)
              and all(x[f"cpu_{kernel}"] == 0 for x in rows))
        worst = max(worst, *rel.values())
        vs_forward = (f"decode vs the mesh forward max |dp| {dp:.3e} "
                      f"({'ok' if consistent else 'FAIL'})" if checked
                      else "no token-only forward to hold decode against")
        print(f"[{tag}] {case}: card vs CPU logits rel prefill "
              f"{rel['prefill']:.3e}, decode ({MESH14_STEPS} steps) "
              f"{rel['decode']:.3e} (limit {tol:g}); {vs_forward}; "
              f"{kernel} launches a rank {launched}, flash heads a launch "
              f"{[x['card_heads'] for x in rows]}, flash at a query offset "
              f"{offset} {'ok' if ok else 'FAIL'} [{card}]", flush=True)
        if not ok:
            fail(f"{tag} {case}: the mesh on the card disagrees with the "
                 f"CPU, or decode with the forward, or the kernel did not "
                 f"run")
        out[case] = {"rel": rel, "max_dp": dp, kernel: launched,
                     "offset": offset}
    return recs, wall, worst


def tensor_parallel_phase(card: str, dev) -> dict:
    """Phase 14: the forward paths tensor-parallel over a data x model mesh
    of ranks sharing the card (module docstring, item 14)."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mesh14_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- 14a: reduced f32 models, card vs CPU, 2 x 2 and 1 x 4 ----
        recs, wall, worst = reduced_mesh(
            card, tmp, "14a", {arch: "flash" for arch in MESH14_REDUCED},
            out)
        out["reduced_wall_s"] = wall
        out["reduced_worst_rel"] = worst
        out["offset_launches"] = sum(r["launches"]["flash_offset"]
                                     for r in recs)
        print(f"[14a] 4 ranks (devices {[r['device'] for r in recs]}) in "
              f"{wall:.1f} s; flash launches at a query offset over the "
              f"ranks {out['offset_launches']} [{card}]", flush=True)
        if not out["offset_launches"]:
            fail("14a: no flash launch at a query offset (context branch)")

        # ---- 14b: deepseek-moe-16b at full width over 1 x 2 ----
        if MESH14_ARCH in PHASE10_LOGITS:
            np.save(tmp / "phase10-logits.npy",
                    PHASE10_LOGITS[MESH14_ARCH].numpy())
        torch.cuda.empty_cache()
        out["full"] = full_width_mesh(card, tmp, "14b", MESH14_RANKS,
                                      MESH14_RANKS, "gloo")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[14] tensor-parallel phase {out['phase_s']:.1f} s", flush=True)
    return out


def full_width_mesh(card: str, tmp, tag: str, world: int, model_axis: int,
                    backend: str) -> dict:
    """deepseek-moe-16b at full width over ``world`` ranks, ``model_axis``
    of them along model (``mesh14_full_rank``); prints and holds the
    records (parameter bytes a rank equal to its shards' and at most
    1.1 / world of one process's, 28 flash launches a rank a forward,
    finite logits and decode, the all-to-all on)."""
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    spec = {"dir": str(tmp), "tag": tag, "world": world,
            "model_axis": model_axis, "backend": backend}
    mesh_lib.run_ranks(mesh14_full_rank, world, (spec,), timeout=900)
    wall = time.perf_counter() - t0
    recs = [json.loads((tmp / f"{tag}-rank{r}.json").read_text())
            for r in range(world)]
    shape = f"{world // model_axis} x {model_axis} {backend} ranks"
    b, s = MESH14_PREFILL
    head = recs[0]
    share = [r["resident_bytes"] / r["one_process_bytes"] for r in recs]
    exact = all(r["resident_bytes"] == r["shard_bytes"] for r in recs)
    flash = [r["launches"]["flash"] for r in recs]
    ms = [max(r["timed"][i]["ms"] for r in recs) for i in range(3)]
    med = statistics.median(ms)
    init_s = [round(r["init_s"], 1) for r in recs]
    staging = [round(r["first"]["staging_ms"], 1) for r in recs]
    limit = MESH14_SHARE * MESH14_RANKS / world
    print(f"[{tag}] {MESH14_ARCH} full width over {shape} "
          f"(devices {[r['device'] for r in recs]}, {wall:.1f} s, init "
          f"{init_s} s): parameter bytes a rank "
          f"{[r['resident_bytes'] for r in recs]} = its shards by "
          f"param_specs {exact}, {[round(x, 4) for x in share]} of one "
          f"process's {head['one_process_bytes'] / 1e9:.2f} GB (limit "
          f"{limit:.3f}); peak {[round(r['peak_gb'], 2) for r in recs]} GB a "
          f"rank [{card}]", flush=True)
    print(f"[{tag}] prefill {b} x {s} through the flash kernel: first "
          f"forward {[round(r['first']['ms'], 1) for r in recs]} ms, median "
          f"of 3 after it (slowest rank) {med:.1f} ms of "
          f"{[round(t, 1) for t in ms]} = {b * s / med * 1e3:,.1f} tokens/s; "
          f"flash launches a rank a forward {flash} "
          f"({[r['launches']['flash_tc'] for r in recs]} on the tensor "
          f"cores); a forward sends along model "
          f"{[r['first']['a2a_bytes'] for r in recs]} B in the all-to-all "
          f"({[round(r['first']['a2a_ms'], 1) for r in recs]} host ms) and "
          f"{[r['first']['model_bytes'] for r in recs]} B in the other "
          f"collectives ({[round(r['first']['model_ms'], 1) for r in recs]} "
          f"host ms), along data (the FSDP leg) "
          f"{[r['first']['line_bytes'] for r in recs]} B "
          f"({[round(r['first']['line_ms'], 1) for r in recs]} host ms), "
          f"staging {staging} host ms; the last timed forward's host ms "
          f"all-to-all / model / data "
          f"{[round(r['timed'][-1]['a2a_ms'], 1) for r in recs]} / "
          f"{[round(r['timed'][-1]['model_ms'], 1) for r in recs]} / "
          f"{[round(r['timed'][-1]['line_ms'], 1) for r in recs]} "
          f"[{card}]", flush=True)
    gaps = [r.get("phase10_gap") for r in recs]
    if all(gaps):
        scale = max(g["scale"] for g in gaps)
        gap = max(g["max_abs"] for g in gaps)
        print(f"[{tag}] last-token logits against phase 10's one-process "
              f"kernel forward (same seed, same tokens): max |diff| "
              f"{gap:.4e}, rel {gap / scale:.4e}, argmax equal on each "
              f"rank's columns {[g['argmax_equal_local'] for g in gaps]} "
              f"(reported: bf16, top-k routing) [{card}]", flush=True)
    dec = [r["decode"] for r in recs]
    db, ds = MESH14_DECODE
    dmed = statistics.median(max(d["step_ms"][i] for d in dec)
                             for i in range(1, ds))
    print(f"[{tag}] decode {db} x {ds} on cache_specs caches: ms a token "
          f"(slowest rank, median after the first) {dmed:.1f} = "
          f"{db * 1e3 / dmed:,.1f} tokens/s; bytes along model "
          f"{[d['a2a_bytes'] for d in dec]} (all-to-all) + "
          f"{[d['model_bytes'] for d in dec]}, along data "
          f"{[d['line_bytes'] for d in dec]}; decode vs the mesh forward "
          f"over the same tokens max |dp| "
          f"{max(d['vs_forward_max_dp'] for d in dec):.3e}, allclose "
          f"{[d['vs_forward_allclose'] for d in dec]}, argmax agreement "
          f"{[round(d['argmax_agreement'], 3) for d in dec]} (reported: "
          f"bf16) [{card}]", flush=True)
    ok = (exact and max(share) <= limit
          and all(f == head["launches"]["flash"] == 28 for f in flash)
          and all(r["logits_finite"] and r["decode"]["finite"]
                  for r in recs)
          and all(r["first"]["a2a_bytes"] > 0 for r in recs))
    if not ok:
        fail(f"{tag}: parameter bytes, flash launches, finiteness or the "
             f"all-to-all off")
    return {"wall_s": wall, "share": share, "shard_bytes_exact": exact,
            "flash_launches": flash, "forward_ms": ms,
            "forward_median_ms": med, "tokens_per_s": b * s / med * 1e3,
            "peak_gb": [r["peak_gb"] for r in recs],
            "first": [r["first"] for r in recs], "gaps": gaps,
            "decode_median_ms": dmed, "decode": dec}


TP15_ARCHS = ("gemma-2b", "qwen2-7b", "deepseek-moe-16b", "mamba2-1.3b")
TP15_MESHES = {"2x2": 2, "1x4": 4}      # [15a], 4 ranks: name -> model axis
TP15_BATCH = (8, 16)                    # [15a] global batch x tokens
TP15_TOL = 1e-4                         # card vs CPU, of max |delta|
TP15_LOSS_TOL = 1e-5
# [15b] / 15c: (arch, world, model axis, backend, batch x tokens, accum,
# steps on one fixed batch: the first a warm-up)
TP15_FULL = ("gemma-2b", 2, 2, "gloo", (2, 2048), 2, 3)
TP15_FOUR = ("qwen2-7b", 4, 4, "nccl", (4, 4096), 4, 3)
# 15c's one-process check: the same widths cut to the depth one card's
# training state holds, one process against the 4 ranks, 3 steps
TP15_FOUR_CUT = TP15_FOUR + (4,)


def tp15_gap(init, got, want) -> float:
    """Max over leaves of |got − want| beyond one f32 spacing of ``want``,
    over max |want − init| (the step's size)."""
    import torch
    worst = 0.0
    for p0, g, w in zip(init, got, want):
        g, w = g.double().cpu(), w.double().cpu()
        scale = float((w - p0.double().cpu()).abs().max())
        slack = torch.nextafter(w.abs().float(), torch.tensor(float("inf"))
                                ).double() - w.abs()
        over = float(((g - w).abs() - slack).max())
        worst = max(worst, over / max(scale, 1e-30))
    return worst


def tp15_reduced_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 15a, one of 4 ranks (gloo, the one card) as 2 x 2 and 1 x 4:
    each reduced f32 model's tensor-parallel step (SGD at lr 1,
    grad_accum 1 and 2) on the card and on the CPU from the same slices,
    the new weights gathered whole; rank 0 writes the gaps to
    ``spec["dir"]``, every rank its launch counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.messages import MeshCollectives
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import make_model
    from repro_torch.sharding import partition
    from repro_torch.util import tree
    from repro_torch.util.device import strict_f32
    strict_f32()
    base = mesh_lib.init_process_mesh(rank, 4, "gloo", store, timeout=120)
    try:
        dev = base.device
        rec: dict = {"device": str(dev), "cases": {}}
        b, s = TP15_BATCH
        for name, model_axis in TP15_MESHES.items():
            mesh = mesh_lib.make_rank_mesh(base, model_axis)
            rows = mesh_lib.batch_rows(mesh, b)
            for arch in TP15_ARCHS:
                for accum in (1, 2):
                    cfg = dataclasses.replace(
                        get_config(arch, reduced=True), dtype="float32",
                        optimizer="sgd", learning_rate=1.0, grad_accum=accum)
                    model = make_model(cfg)
                    specs = model.param_specs(mesh)
                    on_cpu = model.init(seed=0, device="cpu", mesh=mesh)
                    batch = next(synthetic_token_batches(cfg.vocab_size, b,
                                                         s, seed=2))
                    batch = {k: v[rows] for k, v in batch.items()}
                    outs, losses, ms = {}, {}, {}
                    for where in ("card", "cpu"):
                        params = on_cpu if where == "cpu" else \
                            tree.tree_map(lambda t: t.to(dev), on_cpu)
                        comm = MeshCollectives(mesh)
                        t0 = time.perf_counter()
                        new, _, met = model.train_step_deferred(
                            mesh, params, (), batch, comm=comm)
                        losses[where] = float(met["loss"])
                        ms[where] = 1e3 * (time.perf_counter() - t0)
                        outs[where] = [t.cpu() for t in tree.leaves(
                            partition.gather(new, specs, mesh, comm))]
                    init = tree.leaves(partition.gather(
                        on_cpu, specs, mesh, MeshCollectives(mesh)))
                    rec["cases"][f"{arch} accum {accum} {name}"] = {
                        "gap": tp15_gap(init, outs["card"], outs["cpu"]),
                        "loss_rel": abs(losses["card"] - losses["cpu"])
                        / abs(losses["cpu"]),
                        "finite": all(bool(torch.isfinite(t).all())
                                      for t in outs["card"]),
                        "ms": ms}
        rec["launches"] = counts()
        (pathlib.Path(spec["dir"]) / f"r15a-rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def tp15_full_rank(rank: int, store: str, spec: dict) -> None:
    """Phase 15b / 15c, one rank of a data x model mesh (``spec``: arch,
    world, model axis, backend, batch, accum, steps): the model at its
    published widths and depth, its slices drawn by Model.init(mesh=...),
    the config's Adam, ``steps`` tensor-parallel steps of
    train_step_deferred on one fixed batch; its record to
    ``spec["dir"]``."""
    import torch

    from repro_torch.core.messages import MeshCollectives
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.build import _param_shapes, make_model
    from repro_torch.sharding import hints, partition
    from repro_torch.util import tree
    base = mesh_lib.init_process_mesh(rank, spec["world"], spec["backend"],
                                      store, timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, spec["model_axis"])
        dev = mesh.device
        cfg = tp15_config(spec["setup"])
        model = make_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev, mesh=mesh)
        opt_state = model.init_optimizer().init(params)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        specs = model.param_specs(mesh)
        whole = _param_shapes(cfg)
        shard_bytes = sum(
            math.prod(partition.local_shape(
                t.shape, partition.spec_at(specs, path), mesh))
            * t.element_size() for path, t in tree.leaves_with_paths(whole))
        same = [path for path, _ in tree.leaves_with_paths(whole)
                if "model" not in {a for e in partition.spec_at(specs, path)
                                   for a in partition.entry_axes(e)}]
        b, s = spec["batch"]
        batch = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=5))
        rows = mesh_lib.batch_rows(mesh, b)
        batch = {k: v[rows] for k, v in batch.items()}
        comm = MeshCollectives(mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        steps = []
        with hints.sharding_hints(mesh, moe_a2a=True, comm=comm):
            for _ in range(spec["steps"]):
                c0 = (comm.model_bytes, comm.model_s, comm.staging_s,
                      comm.sum_bytes, comm.sum_s)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                params, opt_state, met = model.train_step_deferred(
                    mesh, params, opt_state, batch, comm=comm)
                loss = float(met["loss"])
                ms = 1e3 * (time.perf_counter() - t0)
                local = dict(tree.leaves_with_paths(params))
                steps.append({
                    "ms": ms, "loss": loss,
                    "model_bytes": comm.model_bytes - c0[0],
                    "model_ms": 1e3 * (comm.model_s - c0[1]),
                    "staging_ms": 1e3 * (comm.staging_s - c0[2]),
                    "sum_bytes": comm.sum_bytes - c0[3],
                    "sum_ms": 1e3 * (comm.sum_s - c0[4]),
                    "same_hash": tree_hash([local[p] for p in same])})
        rec = {"device": str(dev), "init_s": init_s, "steps": steps,
               "resident_bytes": tree_bytes(params),
               "shard_bytes": shard_bytes,
               "one_process_bytes": tree_bytes(whole),
               "adam_bytes": tree_bytes(opt_state),
               "adam_one_process_bytes": 2 * sum(
                   t.numel() for t in tree.leaves(whole)) * 4 + 4,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "launches": counts()}
        (pathlib.Path(spec["dir"]) / f"{spec['tag']}-rank{rank}.json"
         ).write_text(json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def tp15_full(card: str, tmp, tag: str, setup, one=None,
              falls: bool = False) -> dict:
    """Runs ``tp15_full_rank`` over ``setup`` (a ``TP15_*``), prints and
    holds the records: bytes a rank equal to its shards', replicated
    leaves equal by hash after every step, losses finite, no kernel
    launched; where ``one`` (one process's losses on the same weights
    and batch, its first steps) is given, each of its steps' loss within
    2^-7 of the ranks'; with ``falls`` the loss before the last step
    below the first's."""
    from repro_torch.launch import mesh as mesh_lib
    arch, world, model_axis, backend, (b, s), accum, n_steps = setup[:7]
    spec = {"dir": str(tmp), "tag": tag, "setup": setup, "world": world,
            "model_axis": model_axis, "backend": backend, "batch": (b, s),
            "steps": n_steps}
    t0 = time.perf_counter()
    mesh_lib.run_ranks(tp15_full_rank, world, (spec,), timeout=900)
    wall = time.perf_counter() - t0
    recs = [json.loads((tmp / f"{tag}-rank{r}.json").read_text())
            for r in range(world)]
    head = recs[0]
    ms = [max(r["steps"][i]["ms"] for r in recs) for i in range(n_steps)]
    timed = ms[1:]
    med = statistics.median(timed)
    losses = [st["loss"] for st in head["steps"]]
    share = [r["resident_bytes"] / r["one_process_bytes"] for r in recs]
    adam_share = [r["adam_bytes"] / r["adam_one_process_bytes"]
                  for r in recs]
    exact = all(r["resident_bytes"] == r["shard_bytes"] for r in recs)
    same = all(len({r["steps"][i]["same_hash"] for r in recs}) == 1
               for i in range(n_steps))
    launched = {k: sum(r["launches"][k] for r in recs)
                for k in head["launches"]}
    shape = f"{world // model_axis} x {model_axis} {backend} ranks"
    depth = "" if len(setup) < 8 else f", cut to {setup[7]} layers"
    print(f"[{tag}] {arch} full width{depth} (Adam, grad_accum {accum}, "
          f"remat) over "
          f"{shape} (devices {[r['device'] for r in recs]}, {wall:.1f} s, "
          f"init {[round(r['init_s'], 1) for r in recs]} s): parameter bytes "
          f"a rank {[r['resident_bytes'] for r in recs]} = its shards by "
          f"param_specs {exact}, {[round(x, 4) for x in share]} of one "
          f"process's {head['one_process_bytes'] / 1e9:.2f} GB; Adam state "
          f"{[r['adam_bytes'] for r in recs]} B a rank, "
          f"{[round(x, 4) for x in adam_share]} of one process's "
          f"{head['adam_one_process_bytes'] / 1e9:.2f} GB; peak "
          f"{[round(r['peak_gb'], 2) for r in recs]} GB a rank [{card}]",
          flush=True)
    print(f"[{tag}] {b} x {s} tokens a step, {n_steps} steps on one fixed "
          f"batch: ms a step (slowest rank) {[round(x, 1) for x in ms]}, "
          f"median of the timed {med:.1f} = {b * s / med * 1e3:,.1f} "
          f"tokens/s; losses {[round(x, 4) for x in losses]}; sent along "
          f"model a step {[r['steps'][-1]['model_bytes'] for r in recs]} B "
          f"in {[round(r['steps'][-1]['model_ms'], 1) for r in recs]} host "
          f"ms (staging {[round(r['steps'][-1]['staging_ms'], 1) for r in recs]}"
          f"), summed over data {[r['steps'][-1]['sum_bytes'] for r in recs]}"
          f" B in {[round(r['steps'][-1]['sum_ms'], 1) for r in recs]} ms; "
          f"replicated leaves equal by hash after every step {same}; kernel "
          f"launches {launched} [{card}]", flush=True)
    ok = (exact and same and all(math.isfinite(x) for x in losses)
          and not any(launched.values()) and max(share) <= 1.1 / model_axis)
    out = {"wall_s": wall, "ms": ms, "median_ms": med, "losses": losses,
           "share": share, "adam_share": adam_share,
           "peak_gb": [r["peak_gb"] for r in recs],
           "peak_bytes": [r["peak_bytes"] for r in recs],
           "resident_bytes": [r["resident_bytes"] for r in recs],
           "model_bytes": [r["steps"][-1]["model_bytes"] for r in recs],
           "model_ms": [r["steps"][-1]["model_ms"] for r in recs]}
    if one is not None:
        rels = [abs(a - w) / abs(w) for a, w in zip(losses, one)]
        print(f"[{tag}] losses against one process's train_step_deferred "
              f"{[round(x, 6) for x in one]}: rel {[f'{r:.3e}' for r in rels]}"
              f" (limit {BF16_TOL:g}) [{card}]", flush=True)
        ok = ok and max(rels) <= BF16_TOL
        out["one_process_rel"] = rels
    if falls:
        print(f"[{tag}] the loss before the last step below the first's: "
              f"{losses[-1] < losses[0]} [{card}]", flush=True)
        ok = ok and losses[-1] < losses[0]
    if not ok:
        fail(f"{tag}: shard bytes, replicated leaves, losses or launches")
    return out


def tp15_config(setup):
    """The config of a ``TP15_*`` setup: the arch's published one with
    the setup's grad_accum (and its depth, where it has one)."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, accum, layers = setup[0], setup[5], setup[7] \
        if len(setup) > 7 else None
    cfg = dataclasses.replace(get_config(arch), grad_accum=accum)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def tp15_one_process(card: str, tag: str, setup, dev, steps: int) -> list:
    """One process's train_step_deferred of ``setup``'s model on its fixed
    batch (the ranks' weights: the same seed), ``steps`` steps on
    ``dev``; its losses, the model freed after."""
    import torch

    from repro_torch.data import synthetic_token_batches
    from repro_torch.models.build import make_model
    cfg = tp15_config(setup)
    b, s = setup[4]
    model = make_model(cfg)
    params = model.init(seed=0, device=dev)
    opt_state = model.init_optimizer().init(params)
    batch = next(synthetic_token_batches(cfg.vocab_size, b, s, seed=5))
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, met = model.train_step_deferred(
            None, params, opt_state, batch)
        losses.append(float(met["loss"]))
    print(f"[{tag}] one process's train_step_deferred ({cfg.name}, "
          f"{cfg.num_layers} layers, {b} x {s}, grad_accum "
          f"{cfg.grad_accum}): losses {losses}, "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms (cold) [{card}]",
          flush=True)
    del model, params, opt_state, met
    torch.cuda.empty_cache()
    return losses


def tp_train_phase(card: str, dev) -> dict:
    """Phase 15: the tensor-parallel training step over rank processes
    sharing the card (module docstring, item 15)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="tp15_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- 15a: reduced f32 models, card vs CPU, 2 x 2 and 1 x 4 ----
        t0 = time.perf_counter()
        mesh_lib.run_ranks(tp15_reduced_rank, 4, ({"dir": str(tmp)},),
                           timeout=600)
        recs = [json.loads((tmp / f"r15a-rank{r}.json").read_text())
                for r in range(4)]
        wall = time.perf_counter() - t0
        worst = 0.0
        for case, res in recs[0]["cases"].items():
            ok = (res["gap"] <= TP15_TOL and res["finite"]
                  and res["loss_rel"] <= TP15_LOSS_TOL)
            worst = max(worst, res["gap"])
            print(f"[15a] {case}: card vs CPU new weights "
                  f"{res['gap']:.3e} of max |delta| (limit {TP15_TOL:g}), "
                  f"loss rel {res['loss_rel']:.3e}; step ms card "
                  f"{res['ms']['card']:.1f}, CPU {res['ms']['cpu']:.1f} "
                  f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
            if not ok:
                fail(f"15a {case}: the tensor-parallel step on the card "
                     f"disagrees with the CPU")
        launched = sum(v for r in recs for v in r["launches"].values())
        print(f"[15a] 4 ranks (devices {[r['device'] for r in recs]}) in "
              f"{wall:.1f} s; kernel launches {launched} [{card}]",
              flush=True)
        if launched:
            fail("15a: a kernel launched in training")
        out["reduced_worst"] = worst
        # ---- 15b: gemma-2b at full width over 1 x 2 ----
        one = tp15_one_process(card, "15b", TP15_FULL, dev, steps=1)
        out["full"] = tp15_full(card, tmp, "15b", TP15_FULL, one,
                                falls=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[15] tensor-parallel training phase {out['phase_s']:.1f} s",
          flush=True)
    return out


DRY16_TOL = 0.10               # [16]: a dry-run peak within 10 % of the card's
DRY16_BUDGET_S = 60.0          # [16]: the phase's seconds
DRY16_TIMEOUT_S = 300
_DRY16 = r"""
import dataclasses, json, sys
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import stand_in_mesh
job = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config(job["arch"]), grad_accum=job["accum"],
                          **job.get("overrides", {}))
shape = InputShape("train", job["seq"], job["batch"], "train")
with stand_in_mesh(tuple(job["dims"]), job["rank"]) as mesh:
    res = dryrun.measure(cfg, shape, mesh)
print("RESULT " + json.dumps(res))
"""


def start_dry_runs(jobs: list) -> list:
    """Each job's dry run (``launch.dryrun.measure`` on ``meta``, one rank
    of a stand-in mesh) started in a process of its own, all together, so
    that no stand-in group is left in this one; the processes."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [subprocess.Popen([sys.executable, "-c", _DRY16, json.dumps(job)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=str(ROOT), env=env)
            for job in jobs]


def dry_results(procs: list, jobs: list) -> list:
    """The records of ``start_dry_runs``' processes, in order.  A run that
    fails or outlives ``DRY16_TIMEOUT_S`` fails the phase."""
    out = []
    try:
        for proc, job in zip(procs, jobs):
            stdout, stderr = proc.communicate(timeout=DRY16_TIMEOUT_S)
            found = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if proc.returncode or not found:
                fail(f"[{job['tag']}] the dry run {job} failed: "
                     f"{stderr[-3000:]}")
            out.append(json.loads(found[-1][len("RESULT "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def dry_runs(jobs: list) -> list:
    """Each job's dry run, all at once; their records, in order."""
    return dry_results(start_dry_runs(jobs), jobs)


def dry_check(tag: str, what: str, predicted: int, measured: int,
              exact: bool, card: str, tol: float = DRY16_TOL) -> bool:
    """Prints the dry run's figure beside the card's; equal, or within
    ``tol`` of it."""
    gap = (predicted - measured) / measured
    ok = predicted == measured if exact else abs(gap) <= tol
    limit = "equal" if exact else f"within {tol:.0%}"
    print(f"[{tag}] {what}: dry run {predicted:,} B, card {measured:,} B, "
          f"gap {gap:+.4%} ({limit}) {'ok' if ok else 'FAIL'} [{card}]",
          flush=True)
    return ok


def dry_jobs(tag: str, setup) -> list:
    """The dry runs of a ``TP15_*`` setup, one a rank."""
    arch, world, model_axis, _, (b, s), accum = setup[:6]
    return [{"tag": tag, "arch": arch, "accum": accum, "batch": b, "seq": s,
             "dims": [world // model_axis, model_axis], "rank": r}
            for r in range(world)]


def dry_rank_checks(tag: str, runs: list, ranks: dict, card: str,
                    tol: float = DRY16_TOL) -> bool:
    """Each rank's parameter bytes and bytes along ``model`` a step equal
    to what the rank processes of phase 15 measured (``tp15_full``'s
    record ``ranks``), its peak within ``tol`` of theirs."""
    ok = True
    for r, res in enumerate(runs):
        ok &= dry_check(f"{tag} rank {r}", "parameter bytes",
                        res["memory"]["arguments"]["params"],
                        ranks["resident_bytes"][r], True, card)
        ok &= dry_check(f"{tag} rank {r}", "bytes along model a step",
                        res["collectives"]["model_bytes"],
                        ranks["model_bytes"][r], True, card)
        ok &= dry_check(f"{tag} rank {r}", "peak of a step",
                        res["memory"]["peak_bytes"], ranks["peak_bytes"][r],
                        False, card, tol)
    return ok


def dryrun_phase(card: str, train: dict, tp: dict) -> dict:
    """Phase 16: the meta-device dry run's predictions against what this
    run measured on the card (module docstring, item 16)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    b, s = TRAIN_BATCH
    jobs = [{"tag": "16a", "arch": TRAIN_ARCH,
             "accum": get_config(TRAIN_ARCH).grad_accum, "batch": b,
             "seq": s, "dims": [1, 1], "rank": 0}] + dry_jobs("16b",
                                                          TP15_FULL)
    runs = dry_runs(jobs)
    for job, res in zip(jobs, runs):
        print(f"[{job['tag']}] dry run {job['arch']} {job['batch']} x "
              f"{job['seq']}, grad_accum {job['accum']}, rank {job['rank']} "
              f"of {' x '.join(map(str, job['dims']))}: stand-ins "
              f"{res['lower_s']:.1f} s, step {res['compile_s']:.1f} s, "
              f"{res['cost']['flops']:.4g} FLOPs, memory "
              f"{json.dumps(res['memory'])}, collectives "
              f"{json.dumps(res['collectives'])}", flush=True)
    full = train["full"]
    ok = dry_check("16a", "arguments (parameters + Adam state + batch)",
                   runs[0]["memory"]["argument_bytes"],
                   sum(full["held_bytes"].values()), True, card)
    ok &= dry_check("16a", "peak of one fixed-batch train_step",
                    runs[0]["memory"]["peak_bytes"], full["step_peak_bytes"],
                    False, card)
    ok &= dry_rank_checks("16b", runs[1:], tp["full"], card)
    seconds = time.perf_counter() - t_phase
    print(f"[16] dry-run phase {seconds:.1f} s (budget "
          f"{DRY16_BUDGET_S:g} s) [{card}]", flush=True)
    if not ok:
        fail("16: a dry-run prediction disagrees with the card")
    if seconds > DRY16_BUDGET_S:
        fail(f"16: the dry-run phase took {seconds:.1f} s")
    return {"runs": runs, "phase_s": seconds}


# [17a]: the reduced archs and the kernel each one's forward launches
SPLIT17_REDUCED = {"deepseek-v3-671b": "flash", "mamba2-1.3b": "ssd"}
# [17b] / [17c] and [18b]-[18d] over 1 x 2 gloo ranks on the card: the
# arch, its config's changes ("over": 17b keeps 8 of mamba2-1.3b's 48
# layers, for the script's time; 17c keeps deepseek-v3-671b's first
# three layers, the dense ones, so no MoE layer is left; 18b keeps
# recurrentgemma-9b's one (rglru, rglru, local attention) period and its
# two rglru_mlp tail blocks), the prefill's batch x tokens (the vision
# prefix's 256 positions before them: 4,096 in all, as input_specs lays
# out train_4k, since attention above its 2,048 chunk takes multiples of
# it; an encoder-decoder's frames, with 1 / DEC_FRACTION as many decoder
# tokens), the decode steps, the training step's batch x tokens (None:
# no step), the kernel the forward launches, its launches a rank a
# forward and the heads of each launch
SPLIT17_FULL = (
    {"tag": "17b", "arch": "mamba2-1.3b",
     "over": {"grad_accum": 2, "num_layers": 8},
     "prefill": (2, 4096), "decode": 0, "train": (2, 4096), "kernel": "ssd",
     "launches": 8, "heads": 32},
    {"tag": "17c", "arch": "deepseek-v3-671b",
     "over": {"grad_accum": 2, "num_layers": 3, "moe": None},
     "prefill": (2, 2048), "decode": 4, "train": (2, 2048),
     "kernel": "flash", "launches": 3, "heads": 64})
SPLIT17_SHARE = 0.55           # parameter bytes a rank, of one process's
SPLIT17_BUDGET_S = 120.0       # [17]'s seconds, reported against
# [18a]: the reduced families over 4 ranks as 2 x 2 and 1 x 4
SPLIT18_REDUCED = {"recurrentgemma-9b": "flash", "internvl2-2b": "flash",
                   "seamless-m4t-medium": "flash"}
SPLIT18_TOL = 1e-5             # [18a] card vs CPU, of max |logit|
SGD1 = {"optimizer": "sgd", "grad_accum": 1}
SPLIT18_FULL = (
    {"tag": "18b", "arch": "recurrentgemma-9b",
     "over": dict(SGD1, num_layers=5), "prefill": (2, 4096), "decode": 4,
     "train": (2, 4096), "kernel": "flash", "launches": 1, "heads": 16},
    {"tag": "18c", "arch": "internvl2-2b", "over": SGD1,
     "prefill": (2, 3840), "decode": 0, "train": (2, 3840),
     "kernel": "flash", "launches": 24, "heads": 8},
    {"tag": "18d", "arch": "seamless-m4t-medium", "over": SGD1,
     "prefill": (2, 4096), "decode": 4, "train": None, "kernel": "flash",
     "launches": 24, "heads": 8})
# parameter bytes a rank, of one process's: internvl2-2b's vocabulary
# (92,553, odd) leaves its embedding and unembedding whole on both ranks
SPLIT18_SHARE = 0.65
SPLIT18_PEAK_TOL = 0.05        # a dry-run peak within 5 % of the card's
SPLIT18_LOSS_TOL = 1e-3        # the split step's loss, of one process's
SPLIT18_BUDGET_S = 180.0       # [18]'s seconds, reported against


def split_config(setup):
    """The config of a ``SPLIT17_FULL`` / ``SPLIT18_FULL`` setup: the
    arch's published one with the setup's changes."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(setup["arch"]), **setup["over"])


def split_batch(cfg, b: int, s: int, seed: int, dev,
                targets: bool = False) -> dict:
    """``b`` x ``s`` tokens (and targets) from the synthetic stream; a
    vision model's prefix before them (random embeddings); an
    encoder-decoder's ``s`` random frames with ``s // DEC_FRACTION``
    decoder tokens.  The same on every rank and process: drawn on the CPU
    from ``seed``."""
    import torch

    from repro_torch.data import synthetic_token_batches
    from repro_torch.models import layers
    from repro_torch.models.build import DEC_FRACTION
    dt = layers.dtype_of(cfg)
    gen = torch.Generator().manual_seed(seed)
    n = s // DEC_FRACTION if cfg.is_encoder_decoder else s
    toks = next(synthetic_token_batches(cfg.vocab_size, b, n, seed=seed))
    batch = {k: torch.as_tensor(toks[k], device=dev)
             for k in (("tokens", "targets") if targets else ("tokens",))}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn(
            (b, cfg.frontend.num_embeddings, cfg.d_model),
            generator=gen).to(device=dev, dtype=dt)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((b, s, cfg.d_model),
                                      generator=gen).to(device=dev, dtype=dt)
    return batch


def split_memory(model, caches, b: int, seed: int, mesh=None) -> None:
    """An encoder-decoder's memory caches filled with random values from
    ``seed`` (a prefill returns them zero), the whole ones or, with
    ``mesh``, this rank's slices of them by ``cache_specs``."""
    import torch

    from repro_torch.sharding import partition
    if not model.cfg.is_encoder_decoder:
        return
    gen = torch.Generator().manual_seed(seed)
    specs = None if mesh is None else model._rank_cache_specs(
        caches, b, False, mesh)
    for k in ("cross_k", "cross_v"):
        slot = caches["dec"][k]
        shape = list(slot.shape)
        if specs is not None:
            shape = [d * int(math.prod(mesh.shape[a] for a in
                                       partition.entry_axes(e)))
                     for d, e in zip(shape, specs["dec"][k])]
        full = torch.randn(shape, generator=gen).to(slot.dtype)
        if specs is not None:
            full = partition.local_slice(full, specs["dec"][k], mesh)
        slot.copy_(full)


def split_rank(rank: int, store: str, spec: dict) -> None:
    """Phases 17b / 17c and 18b-18d, one of 1 x 2 gloo ranks on the card:
    the setup's model at its published widths, its slices drawn by
    Model.init(mesh=...); the prefill forward through its kernel on the
    rank's heads (or query rows, or channels; the counts, and the
    launches by heads, set to 0 just before it and read just after), the
    decode steps (an encoder-decoder's memory caches random), then the
    training step on a fixed batch where the setup has one (its peak from
    the resident state up, its bytes along model); rank 0 writes the
    logits gathered whole, each rank its record, to ``spec["dir"]``."""
    import torch

    from repro_torch.core.messages import MeshCollectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models.build import _param_shapes, make_model
    from repro_torch.sharding import hints, partition
    from repro_torch.util import tree
    from repro_torch.util.device import strict_f32
    strict_f32()
    setup = spec["setup"]
    tag, n_dec = setup["tag"], setup["decode"]
    base = mesh_lib.init_process_mesh(rank, 2, "gloo", store, timeout=120)
    try:
        mesh = mesh_lib.make_rank_mesh(base, 2)
        dev = mesh.device
        cfg = split_config(setup)
        model = make_model(cfg)
        params = model.init(seed=0, device=dev, mesh=mesh)
        specs = model.param_specs(mesh)
        whole = _param_shapes(cfg)
        rec: dict = {"device": str(dev), "resident_bytes": tree_bytes(params),
                     "one_process_bytes": tree_bytes(whole),
                     "shard_bytes": sum(
                         math.prod(partition.local_shape(
                             t.shape, partition.spec_at(specs, path), mesh))
                         * t.element_size()
                         for path, t in tree.leaves_with_paths(whole))}
        b, s = setup["prefill"]
        batch = split_batch(cfg, b, s, 0, dev)
        lspec = partition.logits_spec(cfg, mesh, b)
        with hints.sharding_hints(mesh, moe_a2a=True) as comm, \
                torch.inference_mode():
            torch.cuda.synchronize(dev)
            reset_counts()
            t0 = time.perf_counter()
            logits, _, _ = model.forward(params, batch, use_kernel=True,
                                         last_only=True)
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            rec["launches"] = counts()
            rec["heads"] = launch_heads()
            rec["prefill"] = {"ms": ms, "model_bytes": comm.model_bytes,
                              "model_ms": 1e3 * comm.model_s,
                              "staging_ms": 1e3 * comm.staging_s}
            got = [partition.gather_leaf(logits, lspec, mesh, comm)]
            del logits, batch
            rec["decode"] = {"ms": [], "model_bytes": 0}
            if n_dec:
                steps = torch.as_tensor(mesh14_tokens(
                    cfg.vocab_size, b, n_dec, seed=1), device=dev)
                caches = model.init_cache(b, n_dec, device=dev, mesh=mesh)
                split_memory(model, caches, b, 2, mesh)
                for t in range(n_dec):
                    c0 = comm.model_bytes
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    lg, caches = model.decode_step(params, caches,
                                                   steps[:, t:t + 1])
                    torch.cuda.synchronize(dev)
                    rec["decode"]["ms"].append(
                        1e3 * (time.perf_counter() - t0))
                    rec["decode"]["model_bytes"] += comm.model_bytes - c0
                    got.append(partition.gather_leaf(lg, lspec, mesh, comm))
                del caches
        if rank == 0:
            torch.save([t.float().cpu() for t in got],
                       pathlib.Path(spec["dir"]) / f"{tag}-logits.pt")
        del got
        if setup["train"] is not None:
            # its peak from the resident state up (the f32 unembedding
            # copy of the inference weights let go)
            layers._f32_memo.clear()
            tb, ts = setup["train"]
            batch = split_batch(cfg, tb, ts, 5, dev, targets=True)
            batch = {k: v[mesh_lib.batch_rows(mesh, tb)]
                     for k, v in batch.items()}
            opt_state = model.init_optimizer().init(params)
            comm = MeshCollectives(mesh)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before = counts()
            t0 = time.perf_counter()
            with hints.sharding_hints(mesh, moe_a2a=True, comm=comm):
                new, opt_state, met = model.train_step_deferred(
                    mesh, params, opt_state, batch, comm=comm)
            rec["train"] = {
                "ms": 1e3 * (time.perf_counter() - t0),
                "loss": float(met["loss"]),
                "model_bytes": comm.model_bytes,
                "model_ms": 1e3 * comm.model_s,
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in tree.leaves(new)),
                "launches": sum(counts()[k] - before[k] for k in before)}
        (pathlib.Path(spec["dir"]) / f"{tag}-rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        mesh_lib.destroy(base)


def split_one_process(card: str, setup, dev) -> dict:
    """One process on the card: the setup's model from the ranks' seed,
    the prefill forward through its kernel, the decode steps (the same
    random memory caches) and, where the setup has one, the training step
    on the ranks' batch; the logits and the loss, the model freed
    after."""
    import torch

    from repro_torch.models.build import make_model
    from repro_torch.util.device import strict_f32
    strict_f32()
    tag, n_dec = setup["tag"], setup["decode"]
    cfg = split_config(setup)
    model = make_model(cfg)
    params = model.init(seed=0, device=dev)
    b, s = setup["prefill"]
    t0 = time.perf_counter()
    with torch.inference_mode():
        batch = split_batch(cfg, b, s, 0, dev)
        logits, _, _ = model.forward(params, batch, use_kernel=True,
                                     last_only=True)
        out = [logits.float().cpu()]
        del logits, batch
        if n_dec:
            steps = torch.as_tensor(mesh14_tokens(cfg.vocab_size, b, n_dec,
                                                  seed=1), device=dev)
            caches = model.init_cache(b, n_dec, device=dev)
            split_memory(model, caches, b, 2)
            for t in range(n_dec):
                lg, caches = model.decode_step(params, caches,
                                               steps[:, t:t + 1])
                out.append(lg.float().cpu())
            del caches
    loss = None
    if setup["train"] is not None:
        tb, ts = setup["train"]
        batch = split_batch(cfg, tb, ts, 5, dev, targets=True)
        _, _, met = model.train_step_deferred(
            None, params, model.init_optimizer().init(params), batch)
        loss = float(met["loss"])
        del met, batch
    step = "" if loss is None else (
        f" and one train_step_deferred ({setup['train'][0]} x "
        f"{setup['train'][1]}, grad_accum {cfg.grad_accum}, "
        f"{cfg.optimizer}), loss {loss:.6f}")
    print(f"[{tag}] one process ({cfg.name}, {cfg.num_layers} layers"
          f"{' + MTP' if cfg.mtp_depth else ''}): prefill {b} x {s}, "
          f"{n_dec} decode steps{step} in {time.perf_counter() - t0:.1f} s "
          f"(cold) [{card}]", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": out, "loss": loss}


def split_full(card: str, tmp, setup, dev, share_limit: float,
               loss_tol: float) -> dict:
    """Runs ``split_rank`` over 1 x 2 ranks for ``setup`` after one
    process's run of the same; prints and holds: parameter bytes a rank
    equal to its shards' by param_specs and at most ``share_limit`` of
    one process's, the kernel launched the setup's count of times a rank
    in the forward, each launch on the setup's heads (all on the tensor
    cores), the prefill and decode logits within ``LOGIT_TOL`` of max of
    one process's (bf16 partial sums over ``model``), the training loss
    within ``loss_tol`` of one process's, no kernel in training,
    everything finite."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    tag, arch, kernel = setup["tag"], setup["arch"], setup["kernel"]
    (b, s), n_dec, train = setup["prefill"], setup["decode"], setup["train"]
    one = split_one_process(card, setup, dev)
    t0 = time.perf_counter()
    mesh_lib.run_ranks(split_rank, 2, ({"dir": str(tmp), "setup": setup},),
                       timeout=900)
    wall = time.perf_counter() - t0
    recs = [json.loads((tmp / f"{tag}-rank{r}.json").read_text())
            for r in range(2)]
    got = torch.load(tmp / f"{tag}-logits.pt")
    rels, agree = [], []
    for g, w in zip(got, one["logits"]):
        rels.append(float((g - w).abs().max() / w.abs().max()))
        agree.append(float((g.argmax(-1) == w.argmax(-1)).float().mean()))
    share = [r["resident_bytes"] / r["one_process_bytes"] for r in recs]
    exact = all(r["resident_bytes"] == r["shard_bytes"] for r in recs)
    launched = [r["launches"][kernel] for r in recs]
    on_tc = [r["launches"][f"{kernel}_tc"] for r in recs]
    heads = [sorted(int(h) for h in r["heads"][kernel]) for r in recs]
    cfg = split_config(setup)
    print(f"[{tag}] {arch} full width ({cfg.num_layers} layers"
          f"{' + MTP' if cfg.mtp_depth else ''}) over 1 x 2 gloo ranks "
          f"(devices {[r['device'] for r in recs]}, {wall:.1f} s): "
          f"parameter bytes a rank {[r['resident_bytes'] for r in recs]} = "
          f"its shards by param_specs {exact}, "
          f"{[round(x, 4) for x in share]} of one process's "
          f"{recs[0]['one_process_bytes'] / 1e9:.2f} GB [{card}]", flush=True)
    print(f"[{tag}] prefill {b} x {s} through {kernel} on each rank's share: "
          f"{[round(r['prefill']['ms'], 1) for r in recs]} ms (first, cold), "
          f"{launched} launches a rank ({on_tc} on the tensor cores; "
          f"expected {setup['launches']}), heads a launch {heads} (expected "
          f"{setup['heads']}), sent along model "
          f"{[r['prefill']['model_bytes'] for r in recs]} B in "
          f"{[round(r['prefill']['model_ms'], 1) for r in recs]} host ms; "
          f"the logits against one process's: rel "
          f"{[f'{x:.3e}' for x in rels[:1]]} (limit {LOGIT_TOL:g}), argmax "
          f"agreement {agree[:1]} [{card}]", flush=True)
    if n_dec:
        print(f"[{tag}] {n_dec} decode steps on the rank's cache slices: ms "
              f"{[[round(x, 1) for x in r['decode']['ms']] for r in recs]}, "
              f"sent along model {[r['decode']['model_bytes'] for r in recs]}"
              f" B; the logits against one process's: rel "
              f"{[f'{x:.3e}' for x in rels[1:]]} (limit {LOGIT_TOL:g}), "
              f"argmax agreement {agree[1:]} [{card}]", flush=True)
    ok = (exact and max(share) <= share_limit
          and all(n == setup["launches"] for n in launched)
          and on_tc == launched and all(h == [setup["heads"]] for h in heads)
          and max(rels) <= LOGIT_TOL
          and all(math.isfinite(x) for x in rels))
    res = {"wall_s": wall, "launches": launched, "heads": heads,
           "logits_rel": rels,
           "resident_bytes": [r["resident_bytes"] for r in recs],
           "prefill_model_bytes": [r["prefill"]["model_bytes"]
                                   for r in recs]}
    if train is not None:
        losses = [r["train"]["loss"] for r in recs]
        loss_rel = max(abs(x - one["loss"]) / abs(one["loss"])
                       for x in losses)
        print(f"[{tag}] one train_step_deferred {train[0]} x {train[1]} "
              f"(grad_accum {cfg.grad_accum}, {cfg.optimizer}): "
              f"{[round(r['train']['ms'], 1) for r in recs]} ms, loss "
              f"{losses} against one process's {one['loss']:.6f}: rel "
              f"{loss_rel:.3e} (limit {loss_tol:g}); sent along model "
              f"{[r['train']['model_bytes'] for r in recs]} B in "
              f"{[round(r['train']['model_ms'], 1) for r in recs]} host ms; "
              f"peak {[r['train']['peak_bytes'] for r in recs]} B a rank; "
              f"kernel launches {[r['train']['launches'] for r in recs]} "
              f"[{card}]", flush=True)
        ok &= (loss_rel <= loss_tol
               and all(math.isfinite(x) for x in losses)
               and all(r["train"]["finite"] and not r["train"]["launches"]
                       for r in recs))
        res.update(loss_rel=loss_rel,
                   model_bytes=[r["train"]["model_bytes"] for r in recs],
                   peak_bytes=[r["train"]["peak_bytes"] for r in recs])
    if not ok:
        fail(f"{tag}: shard bytes, launches on the rank's share, logits, "
             f"loss or finiteness")
    return res


def split_dry_jobs(setup) -> list:
    """The dry runs of a setup's training step, one a rank of 1 x 2 (the
    vision prefix's positions in the sequence)."""
    from repro_torch.configs import get_config
    tb, ts = setup["train"]
    cfg = get_config(setup["arch"])
    if cfg.arch_type == "vlm":
        ts += cfg.frontend.num_embeddings
    over = dict(setup["over"])
    accum = over.pop("grad_accum")
    return [{"tag": setup["tag"], "arch": setup["arch"], "accum": accum,
             "overrides": over, "batch": tb, "seq": ts, "dims": [1, 2],
             "rank": r} for r in range(2)]


def split_full_phase(card: str, tmp, setups, dry: list, dev, share: float,
                     loss_tol: float, peak_tol: float) -> dict:
    """Runs ``split_full`` for each setup, the dry runs of the ``dry``
    ones' training steps in processes beside them; prints the dry runs
    and holds each rank's parameter bytes and bytes along ``model``
    equal to the card's, its peak within ``peak_tol``."""
    out = {}
    jobs = [job for setup in dry for job in split_dry_jobs(setup)]
    procs = start_dry_runs(jobs)
    try:
        for setup in setups:
            out[setup["tag"]] = split_full(card, tmp, setup, dev, share,
                                           loss_tol)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    runs = dry_results(procs, jobs)
    ok = True
    for job, res in zip(jobs, runs):
        print(f"[{job['tag']}] dry run rank {job['rank']} of 1 x 2: "
              f"stand-ins {res['lower_s']:.1f} s, step "
              f"{res['compile_s']:.1f} s, {res['cost']['flops']:.4g} FLOPs, "
              f"memory {json.dumps(res['memory'])}, collectives "
              f"{json.dumps(res['collectives'])}", flush=True)
    for setup in dry:
        tag = setup["tag"]
        mine = [res for job, res in zip(jobs, runs) if job["tag"] == tag]
        ok &= dry_rank_checks(tag, mine, out[tag], card, peak_tol)
    if not ok:
        fail(f"{'/'.join(s['tag'] for s in dry)}: a dry-run prediction "
             f"disagrees with the card")
    return out


def split_phase(card: str, dev) -> dict:
    """Phase 17: MLA and the Mamba-2 SSD mixer split over model, on the
    rank's heads (module docstring, item 17)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="split17_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- 17a: reduced f32 models, card vs CPU, 2 x 2 and 1 x 4 ----
        recs, wall, worst = reduced_mesh(card, tmp, "17a", SPLIT17_REDUCED,
                                         out)
        out["reduced"] = {k: sum(r["launches"][k] for r in recs)
                          for k in ("flash", "ssd")}
        print(f"[17a] 4 ranks (devices {[r['device'] for r in recs]}) in "
              f"{wall:.1f} s, worst rel {worst:.3e}; launches over the "
              f"ranks {out['reduced']} [{card}]", flush=True)
        # ---- 17b / 17c: full width over 1 x 2; 17c's dry runs beside ----
        out.update(split_full_phase(card, tmp, SPLIT17_FULL,
                                    SPLIT17_FULL[1:], dev, SPLIT17_SHARE,
                                    BF16_TOL, DRY16_TOL))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[17] split MLA / SSD phase {out['phase_s']:.1f} s (target "
          f"{SPLIT17_BUDGET_S:g} s) [{card}]", flush=True)
    return out


def split18_phase(card: str, dev) -> dict:
    """Phase 18: the RG-LRU hybrid, the vision prefix and the
    encoder-decoder split over model (module docstring, item 18)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="split18_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- 18a: reduced f32 families, card vs CPU, 2 x 2 and 1 x 4 ----
        recs, wall, worst = reduced_mesh(card, tmp, "18a", SPLIT18_REDUCED,
                                         out, SPLIT18_TOL)
        out["reduced_worst"] = worst
        print(f"[18a] 4 ranks (devices {[r['device'] for r in recs]}) in "
              f"{wall:.1f} s, worst rel {worst:.3e} [{card}]", flush=True)
        # ---- 18b-18d: full width over 1 x 2; the dry runs beside ----
        out.update(split_full_phase(
            card, tmp, SPLIT18_FULL,
            [setup for setup in SPLIT18_FULL if setup["train"] is not None],
            dev, SPLIT18_SHARE, SPLIT18_LOSS_TOL, SPLIT18_PEAK_TOL))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[18] split RG-LRU hybrid / vision prefix / encoder-decoder "
          f"phase {out['phase_s']:.1f} s (target {SPLIT18_BUDGET_S:g} s) "
          f"[{card}]", flush=True)
    return out


def four_card_mesh_phase(card: str) -> None:
    """Phases 14c and 15c, where four cards are given (``--four-cards``;
    not part of the run with no arguments): the full-width
    deepseek-moe-16b of 14b over NCCL ranks, one a card, at 1 x 4 and at
    2 x 2 (its FSDP leg live: the input dims over data too), then
    qwen2-7b's tensor-parallel training step at full width over 1 x 4."""
    import torch
    if torch.cuda.device_count() < 4:
        fail(f"14c needs four cards, found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="mesh14c_") as tmp:
        tmp = pathlib.Path(tmp)
        for model_axis in (4, 2):
            full_width_mesh(card, tmp, f"14c-{4 // model_axis}x{model_axis}",
                            4, model_axis, "nccl")
        one = tp15_one_process(card, "15c", TP15_FOUR_CUT,
                               torch.device("cuda", 0), TP15_FOUR_CUT[6])
        tp15_full(card, tmp, "15c-cut", TP15_FOUR_CUT, one)
        ranks = tp15_full(card, tmp, "15c", TP15_FOUR)
    t0 = time.perf_counter()
    if not dry_rank_checks("16c", dry_runs(dry_jobs("16c", TP15_FOUR)),
                           ranks, card):
        fail("16c: a dry-run prediction disagrees with the cards")
    print(f"[16c] dry-run phase {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import gcn_paper
    from repro_torch.core import graph, messages
    from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
    from repro_torch.kernels import build, community_spmm, fista, ref
    from repro_torch.launch import roofline
    from repro_torch.util.device import strict_f32

    strict_f32()
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[0] {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {card}", flush=True)

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.load_all(build.LIBRARIES)
    print(f"[1] built {KERNEL_SRC}, {FUSED_SRC}, {SSD_SRC}, {SSD_TC_SRC}, "
          f"{FLASH_SRC}, {FLASH_TC_SRC} and {FISTA_SRC} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if sys.argv[1:] == ["--four-cards"]:
        four_card_mesh_phase(card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. kernel vs plain version on the card ----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    checks: list[dict] = []
    max_abs = 0.0
    k = d = 3
    n_full = 4584
    blocks_full = torch.randn((k, d, n_full, n_full), generator=gen,
                              device=dev)
    idx_full = torch.arange(d, **i32).repeat(k, 1).contiguous()
    ones = torch.ones((k, d), **i32)
    rows_full = torch.full((k,), n_full, **i32)
    nbrs_full = torch.full((k, d), n_full, **i32)
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        max_abs = max(max_abs, check_case(
            f"full k=D=3 n_pad={n_full} C={c} f32", blocks_full, idx_full,
            ones, z, rows_full, nbrs_full, checks))
    z = torch.randn((k, n_full, 1000), generator=gen, device=dev)
    max_abs = max(max_abs, check_case(
        f"full k=D=3 n_pad={n_full} C=1000 bf16",
        blocks_full.to(torch.bfloat16), idx_full, ones, z, rows_full,
        nbrs_full, checks))
    del z

    g_r, part_r = graph.synthetic_powerlaw_communities(
        32, nodes_per_part=32, size_skew=1.0)
    lay = graph.build_community_layout(g_r.num_nodes, g_r.edges, part_r,
                                       compressed=True, pad_mode="bucketed")
    csr = lay.compress()
    rc, nc = csr.ell_row_counts()
    if not (rc < lay.n_pad).any():
        fail("the ragged layout has no row count below n_pad")
    rng = np.random.default_rng(0)
    m_r = csr.num_parts
    # masked slots point anywhere in range: their indices are never read
    idx_r = np.where(csr.ell_mask > 0, csr.ell_indices,
                     rng.integers(0, m_r, size=csr.ell_indices.shape))
    ragged = [torch.as_tensor(x, device=dev) for x in
              (csr.ell_blocks, idx_r.astype(np.int32),
               (csr.ell_mask != 0).astype(np.int32), rc, nc)]
    for c, dt in ((64, torch.float32), (10, torch.float32),
                  (64, torch.bfloat16)):
        z = torch.randn((m_r, lay.n_pad, c), generator=gen, device=dev)
        b, ix, mk, r_, n_ = ragged
        max_abs = max(max_abs, check_case(
            f"ragged M=32 n_pad={lay.n_pad} D={csr.max_deg} C={c} "
            f"{str(dt).split('.')[-1]} (masked slots re-pointed)",
            b.to(dt), ix, mk, z, r_, n_, checks))
    max_rel = max(ch["max_rel_err"] for ch in checks)

    # the dense kernel at the trainer's shapes: blocks_full is (k, M, n, n)
    dense_checks: list[dict] = []
    all_live = torch.ones((k, d), **i32)
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        check_dense_case(f"k=M=3 n_pad={n_full} C={c} all live",
                         blocks_full, z, all_live, dense_checks)
    # absent blocks hold the random values of blocks_full: the plain
    # version multiplies them by 0, the kernel must skip them
    lane_mask = torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0]], **i32)
    z = torch.randn((k, n_full, 1000), generator=gen, device=dev)
    check_dense_case(f"k=M=3 n_pad={n_full} C=1000 per-lane masks "
                     f"{lane_mask.tolist()} (absent blocks random)",
                     blocks_full, z, lane_mask, dense_checks)
    check_dense_case(f"k=M=3 n_pad={n_full} C=1000 shared row [1, 0, 1]",
                     blocks_full, z, lane_mask[0], dense_checks)
    check_dense_case(f"k=M=3 n_pad={n_full} C=1000 mask=None", blocks_full,
                     z, None, dense_checks)
    check_dense_case(f"one block row M=3 n_pad={n_full} C=1000 row [1, 0, 1]",
                     blocks_full[0], z, lane_mask[0], dense_checks)
    del z
    a_r = torch.as_tensor(lay.a_blocks, device=dev)
    nbr_r = torch.as_tensor(lay.neighbor_mask, device=dev).to(torch.int32)
    for c in (64, 10):
        z = torch.randn((m_r, lay.n_pad, c), generator=gen, device=dev)
        check_dense_case(f"ragged M={m_r} n_pad={lay.n_pad} C={c} "
                         f"neighbour mask ({int(nbr_r.sum())} live blocks)",
                         a_r, z, nbr_r, dense_checks)
    del a_r, z

    # packed and fused kernels at the server's shapes: one lane, 16 slots of
    # 864 rows back to back on a 13,824-row plane; slot 0 is the self slot
    n_s, d_s = 864, SERVE_PARTS
    blocks_s = torch.randn((1, d_s, n_s, n_s), generator=gen, device=dev)
    off_s = (torch.arange(d_s, **i32) * n_s)[None].contiguous()
    mask_s = torch.ones((1, d_s), **i32)
    rows_s = torch.full((1,), n_s, **i32)
    nbrs_s = torch.full((1, d_s), n_s, **i32)
    self_s = torch.zeros((1, d_s), dtype=torch.float32, device=dev)
    self_s[0, 0] = 1.0
    packed_checks: list[dict] = []
    fused_checks: list[dict] = []
    planes = {c: torch.randn((d_s * n_s, c), generator=gen, device=dev)
              for c in (767, 1000)}
    serve_ops = (off_s, mask_s)
    for c, dt in ((767, torch.float32), (1000, torch.float32),
                  (1000, torch.bfloat16)):
        check_packed_case(
            f"k=1 D={d_s} n_pad={n_s} plane={d_s * n_s} C={c} "
            f"{str(dt).split('.')[-1]}", blocks_s.to(dt), *serve_ops,
            planes[c], rows_s, nbrs_s, packed_checks)
    check_packed_case(f"halo mask k=1 D={d_s} n_pad={n_s} C=1000 f32",
                      blocks_s, off_s, mask_s.float(), planes[1000], rows_s,
                      nbrs_s, packed_checks, self_mask=self_s)
    for c_in, c_out in ((767, 1000), (1000, 10)):
        w = torch.randn((c_in, c_out), generator=gen, device=dev) / 30.0
        check_fused_case(f"k=1 D={d_s} n_pad={n_s} {c_in}->{c_out} f32",
                         blocks_s, *serve_ops, planes[c_in], w, rows_s,
                         nbrs_s, fused_checks)
    del planes

    # the ragged layout on one packed plane, masked slots re-pointed
    dl_r = lay.device_layout(1)
    off_r = messages.plane_read_offsets(csr.ell_indices, csr.ell_mask,
                                        dl_r.local_offsets)
    dead = csr.ell_mask == 0
    off_r = np.where(dead, rng.integers(0, dl_r.plane_rows,
                                        size=off_r.shape), off_r)
    nc_r = np.where(dead, rng.integers(0, lay.n_pad + 1, size=nc.shape), nc)
    packed_r = [torch.as_tensor(x, device=dev) for x in
                (csr.ell_blocks, off_r.astype(np.int32),
                 (csr.ell_mask != 0).astype(np.int32), rc,
                 nc_r.astype(np.int32))]
    b, o_, mk, r_, n_ = packed_r
    planes = {c: torch.randn((dl_r.plane_rows, c), generator=gen, device=dev)
              for c in (64, 10)}
    tag = (f"ragged M={m_r} n_pad={lay.n_pad} D={csr.max_deg} plane "
           f"{dl_r.plane_rows} (masked slots re-pointed)")
    for c, dt in ((64, torch.float32), (10, torch.float32),
                  (64, torch.bfloat16)):
        check_packed_case(f"{tag} C={c} {str(dt).split('.')[-1]}",
                          b.to(dt), o_, mk, planes[c], r_, n_, packed_checks)
    self_r = torch.as_tensor(messages.self_slot_mask(
        csr.ell_indices, csr.ell_mask), device=dev)
    check_packed_case(f"{tag} halo mask C=64 f32", b, o_, mk.float(),
                      planes[64], r_, n_, packed_checks, self_mask=self_r)
    for c_in, c_out in ((64, 10), (10, 64)):
        w = torch.randn((c_in, c_out), generator=gen, device=dev)
        check_fused_case(f"{tag} {c_in}->{c_out} f32", b, o_, mk,
                         planes[c_in], w, r_, n_, fused_checks)
    del planes

    # ---- 3. the trainer at full width -------------------------------------
    cfg, admm = gcn_paper.config("amazon_computers")
    t0 = time.perf_counter()
    g = graph.synthetic_sbm("amazon_computers", seed=0)
    trainer = ParallelADMMTrainer(cfg, admm, g, num_parts=3, seed=0,
                                  config=TrainerConfig.packed(use_kernel=True),
                                  device="cuda")
    torch.cuda.synchronize()
    lay = trainer.layout
    print(f"[3] set-up {time.perf_counter() - t0:.1f} s: {g.num_nodes} nodes, "
          f"{g.num_edges} edges, GCN {cfg.layer_dims}, M={lay.num_parts}, "
          f"n_pad={lay.n_pad}, row counts {lay.eff_row_counts().tolist()}, "
          f"max_deg {trainer.layout.compress().max_deg}, packed plane "
          f"{trainer.packed_layout.total_rows} rows", flush=True)

    # objectives and one step, kernel path vs plain path, one shared state
    s0 = trainer.state
    worst0 = objective_gap(trainer)
    print(f"[3] initial state: objectives and gradients, kernel vs plain "
          f"path: max rel diff {worst0:.3e} (reported: every residual of "
          f"the initial state is float noise)", flush=True)
    s_k = trainer.next_state(s0, use_kernel=True)
    s_p = trainer.next_state(s0, use_kernel=False)
    same = all(torch.equal(a, b) for a, b in
               zip(s_k.taus + s_k.thetas, s_p.taus + s_p.thetas))
    print(f"[3] one step from the initial state: tau/theta agree between "
          f"kernel and plain paths: {same} (reported, not asserted: a "
          f"reassociation may flip a line search)", flush=True)
    trainer.state = s0
    del s_k, s_p
    peak_flops, peak_bf16, peak_bw = roofline.peaks(name)
    fista_t = fista_phase(trainer, s0, admm, peak_flops, peak_bw, card)
    trainer.state = s0

    reset_counts()
    fista.launches = 0
    log = trainer.train(EPOCHS)
    launches = community_spmm.launches
    fista_launches = fista.launches
    print_log("3", log)
    check_finite_log(log, "packed ELL")
    st = trainer.state
    for t in st.weights + st.zs + (st.u,) + st.taus + st.thetas:
        if not bool(torch.isfinite(t).all()):
            fail("a non-finite value in the trainer state")
    if launches == 0:
        fail("the training run never launched the CUDA kernel")
    worst = objective_gap(trainer)
    print(f"[3] trained state: objectives and gradients, kernel vs plain "
          f"path: max rel diff {worst:.3e}", flush=True)
    if not worst <= TOL:
        fail(f"objectives differ between paths by {worst:.3e}")
    community_spmm.launches = 0
    fista.launches = 0
    trainer.step()
    per_step = community_spmm.launches
    fista_per_step = fista.launches
    print(f"[3] kernel launches: {launches} in {EPOCHS} epochs "
          f"({launches / EPOCHS:g} per epoch), {per_step} per step; Z_L "
          f"prox {fista_launches} in {EPOCHS} epochs, {fista_per_step} per "
          f"step", flush=True)
    if fista_launches != EPOCHS or fista_per_step != 1:
        fail(f"the Z_L prox kernel ran {fista_launches} times in {EPOCHS} "
             f"epochs and {fista_per_step} in a step, not once a step")

    wall_us, busy_us, idle = profiled_idle(trainer.step)
    print(f"[3] profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, device idle share {idle}", flush=True)
    blocks = trainer.data.ell_blocks
    f32_blocks = blocks.numel() * blocks.element_size()
    f32_resident = trainer.data.adjacency_nbytes
    del trainer, blocks, s0, st
    torch.cuda.empty_cache()

    # ---- 3, continued: dense, serial, baseline, bf16 ----------------------
    dense = dense_train_phase(cfg, admm, g, card, dev)
    serial = serial_phase(cfg, admm, g, card, dev, dense["median_step_ms"])
    bf16 = bf16_phase(cfg, admm, g, card, dev, f32_blocks, f32_resident)

    # ---- 3m. M = 3 over 3 loopback shards: the packed and fused kernels ---
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3p_") as tmp:
        saved = {"dir": tmp}
        multi = multishard_phase(cfg, admm, g, card, dev, peak_flops,
                                 peak_bw, saved)

        # ---- 3p. M = 3 over 3 rank processes on the card ---------------
        procs = process_phase(card, saved)
        del saved

    # ---- 4. times -----------------------------------------------------------
    per_c = {}
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        args = (blocks_full, idx_full, ones, z, rows_full, nbrs_full)

        def composition(z=z):
            zg = z[idx_full.long()] * ones[..., None, None].float()
            return torch.einsum("mdip,mdpc->mic", blocks_full, zg)

        before = community_spmm.launches
        ms = median_ms(lambda: community_spmm.community_spmm_ell(*args), 7)
        community_spmm.launches = before      # timing launches do not count
        plain_ms = median_ms(lambda: ref.community_spmm_ell_einsum(*args), 5)
        lib_ms = median_ms(composition, 5)
        flops, nbytes = work(blocks_full, idx_full, ones, rows_full,
                             nbrs_full, c)
        t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bw
        lay = community_spmm.operand_layout(blocks_full, z)
        per_c[c] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                    "tflops": flops / ms / 1e9, "layout": lay}
        print(f"[4] C={c}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain version {plain_ms:.3f} "
              f"ms, gather+einsum {lib_ms:.3f} ms, bound "
              f"{per_c[c]['bound_ms']:.3f} ms ({per_c[c]['bound_by']}; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
              f"{layout_text(lay)} [{card}]", flush=True)
        del z
    dense_c = {}
    for c in (767, 1000, 10):
        z = torch.randn((k, n_full, c), generator=gen, device=dev)
        t = dense_c[c] = time_dense(blocks_full, all_live, z, peak_flops,
                                    peak_bw)
        print(f"[4] dense C={c} ({t['live_blocks']} live blocks): kernel "
              f"{t['ms']:.3f} ms ({t['gflop'] / t['ms']:.1f} TFLOP/s), plain "
              f"version {t['plain_ms']:.3f} ms, masked einsum "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']}; {t['gflop']:.1f} GFLOP, {t['mbytes']:.1f} "
              f"MB); {layout_text(t['layout'])} [{card}]", flush=True)
        del z
    steps = log.epoch_time_s
    print(f"[4] full-width step, packed ELL: median "
          f"{1e3 * statistics.median(steps):.1f} ms over {len(steps)} epochs "
          f"(first includes warm-up), launches {per_step}/step, "
          f"{launches / EPOCHS:g}/epoch, idle share {idle} [{card}]",
          flush=True)
    print(f"[4] full-width step, dense: median {dense['median_step_ms']:.1f} "
          f"ms, launches {dense['per_step']}/step, "
          f"{dense['launches'] / EPOCHS:g}/epoch, idle share {dense['idle']}; "
          f"serial: median {serial['median_step_ms']:.1f} ms; bf16 packed "
          f"ELL: steps {[round(t, 1) for t in bf16['steps_ms']]} ms [{card}]",
          flush=True)

    del blocks_full
    torch.cuda.empty_cache()

    # ---- 5. serving at full width ------------------------------------------
    serve = serve_phase(cfg, admm, g, card, dev)

    # ---- 6. packed and fused kernel times at the server's shapes ----------
    packed_c, fused_c = {}, {}
    for c in (767, 1000):
        z = torch.randn((d_s * n_s, c), generator=gen, device=dev)
        t = packed_c[c] = time_packed(blocks_s, off_s, mask_s, rows_s, nbrs_s,
                                      z, peak_flops, peak_bw,
                                      self_mask=self_s)
        print(f"[6] packed halo pass k=1 D={d_s} ({t['live_slots']} live) "
              f"n_pad={n_s} C={c}: kernel {t['ms']:.3f} ms, plain version "
              f"{t['plain_ms']:.3f} ms, gather+einsum {t['library_ms']:.3f} "
              f"ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}; "
              f"{t['gflop']:.2f} GFLOP, {t['mbytes']:.1f} MB); "
              f"{layout_text(t['layout'])} [{card}]", flush=True)
        del z
    for c_in, c_out in ((767, 1000), (1000, 10)):
        z = torch.randn((d_s * n_s, c_in), generator=gen, device=dev)
        w = torch.randn((c_in, c_out), generator=gen, device=dev)
        t = fused_c[(c_in, c_out)] = time_packed(
            blocks_s, off_s, mask_s, rows_s, nbrs_s, z, peak_flops, peak_bw,
            w=w)
        grid = community_spmm.fused_grid(1, n_s, c_in)
        t.update(grid=grid, cluster=grid[0], blocks=math.prod(grid))
        print(f"[6] fused cold path k=1 D={d_s} ({t['live_slots']} live) "
              f"n_pad={n_s} {c_in}->{c_out}: grid {grid} = {t['blocks']} "
              f"blocks in clusters of {grid[0]}: kernel {t['ms']:.3f} ms, "
              f"plain version {t['plain_ms']:.3f} ms, gather+einsum+matmul "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']}; {t['gflop']:.2f} GFLOP, "
              f"{t['mbytes']:.1f} MB) [{card}]", flush=True)
        del z, w

    # ---- 7. SSD scan and flash attention kernels vs plain versions ---------
    ssd_checks, flash_checks = check_lm_kernels(gen, dev)

    # ---- 8. Mamba-2 1.3B: prefill through the SSD kernel, cached decode ----
    mamba = mamba_phase(card, dev)

    # ---- 9. SSD scan and flash attention times ------------------------------
    ssd_t, flash_t = time_lm_kernels(gen, dev, peak_flops, peak_bf16,
                                     peak_bw, card)

    # ---- 10. the attention families through the flash kernel --------------
    families = families_phase(card, dev)

    # ---- 11. language-model training: no kernel launched -------------------
    train = training_phase(card, dev, peak_bf16)

    # ---- 12. the invariant linter on the card ------------------------------
    analysis_phase(cfg, admm, g, card, dev)

    # ---- 13. the language models over a data x model mesh of ranks ---------
    mesh_phase(card, dev)

    # ---- 14. the forward paths tensor-parallel over the mesh ---------------
    tp = tensor_parallel_phase(card, dev)

    # ---- 15. the tensor-parallel training step over the mesh ---------------
    tp_train = tp_train_phase(card, dev)

    # ---- 16. the meta-device dry run against phases 11 and 15b -------------
    dryrun_phase(card, train, tp_train)

    # ---- 17. MLA and the SSD mixer split over model, on the rank's heads ---
    split = split_phase(card, dev)

    # ---- 18. the RG-LRU hybrid, vision prefix, encoder-decoder split -------
    split18 = split18_phase(card, dev)

    # ---- 19. the kernels line, the card, the result ------------------------
    main_c = 1000
    rows_out = [{
        "name": "community_spmm_ell", "route": "cuda",
        "source": KERNEL_SRC, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_abs,
        "ms": per_c[main_c]["ms"], "plain_ms": per_c[main_c]["plain_ms"],
        "bound_ms": per_c[main_c]["bound_ms"],
        "bound_by": per_c[main_c]["bound_by"],
        "library_ms": per_c[main_c]["library_ms"],
        "timed_at": {"k": k, "max_deg": d, "n_pad": n_full, "C": main_c},
        "design": ELL_DESIGN, "layout": per_c[main_c]["layout"],
        "checked": True, "max_rel_err": max_rel,
        "per_c": {str(c): v for c, v in per_c.items()}}]
    # the packed and fused rows: launches of the 3-shard training runs
    # (phase 3m, the trainer's path), timed at its stacked shapes; the
    # server's shapes and launch counts beside them
    stacked = multi["stacked"]
    head = multi["timed"][main_c]["packed"]
    rows_out.append({
        "name": "community_spmm_ell_packed", "route": "cuda",
        "source": KERNEL_SRC, "replaces": PACKED_REPLACES,
        "launches": multi["unfused"]["launches"]["packed"],
        "max_abs_err": max([ch["max_abs_err"] for ch in packed_checks]
                           + [r["packed_max_abs_err"] for r in stacked]),
        "max_rel_err": max([ch["max_rel_err"] for ch in packed_checks]
                           + [r["packed_max_rel_err"] for r in stacked]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": {"k": 3, "max_deg": 3, "shards": SHARDS,
                     "live_slots": head["live_slots"], "n_pad": n_full,
                     "plane_rows": stacked[1]["plane_rows"], "C": main_c},
        "design": ELL_DESIGN, "layout": head["layout"],
        "checked": True,
        "stacked_bitwise_per_shard": all(
            r["packed_bitwise_per_shard"] for r in stacked),
        "launches_fused_run": multi["fused"]["launches"]["packed"],
        "launches_3p_per_rank_step": [
            [c["packed"] for c in p] for p in procs["unfused"]["per_step"]],
        "launches_serving_cached_run": serve["launches"]["cached"]["packed"],
        "launches_serving_cold_run": serve["launches"]["cold"]["packed"],
        "trainer_per_c": {str(c): v["packed"]
                          for c, v in multi["timed"].items()},
        "serving_per_c": {str(c): v for c, v in packed_c.items()}})
    head = multi["timed"][767]["fused"]
    rows_out.append({
        "name": "community_spmm_ell_fused", "route": "cuda",
        "source": FUSED_SRC, "replaces": FUSED_REPLACES,
        "launches": multi["fused"]["launches"]["fused"],
        "max_abs_err": max([ch["max_abs_err"] for ch in fused_checks]
                           + [r["fused_max_abs_err"] for r in stacked]),
        "max_rel_err": max([ch["max_rel_err"] for ch in fused_checks]
                           + [r["fused_max_rel_err"] for r in stacked]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": {"k": 3, "max_deg": 3, "shards": SHARDS,
                     "live_slots": head["live_slots"], "n_pad": n_full,
                     "plane_rows": stacked[0]["plane_rows"], "C_in": 767,
                     "C_out": 1000},
        "design": "32-row tile per thread-block cluster, C_in chunks over "
                  "the cluster, aggregate in distributed shared memory",
        "cluster": head["cluster"], "blocks": head["blocks"],
        "checked": True,
        "stacked_bitwise_per_shard": all(
            r["fused_bitwise_per_shard"] for r in stacked),
        "max_rel_err_vs_packed_then_matmul": max(
            [ch["rel_err_vs_packed_then_matmul"] for ch in fused_checks]
            + [r["fused_rel_err_vs_packed_then_matmul"] for r in stacked]),
        "launches_serving_fused_cold_run":
            serve["launches"]["fused_cold"]["fused"],
        "launches_3p_per_rank_step": [
            [c["fused"] for c in p] for p in procs["fused"]["per_step"]],
        "trainer_per_shape": {
            f"{c}->{1000 if c == 767 else 10}": v["fused"]
            for c, v in multi["timed"].items()},
        "serving_per_shape": {f"{a}->{b}": v
                              for (a, b), v in fused_c.items()}})
    head = dense_c[main_c]
    rows_out.append({
        "name": "community_spmm", "route": "cuda",
        "source": KERNEL_SRC, "replaces": DENSE_REPLACES,
        "design": DENSE_DESIGN, "layout": head["layout"],
        "launches": dense["launches"],
        "max_abs_err": max(ch["max_abs_err"] for ch in dense_checks),
        "max_rel_err": max(ch["max_rel_err"] for ch in dense_checks),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": {"k": k, "M": d, "live_blocks": head["live_blocks"],
                     "n_pad": n_full, "C": main_c},
        "checked": True,
        "vs_ell_kernel_bitwise": dense["vs_ell_bitwise"],
        "vs_ell_kernel_rel_err": dense["vs_ell_rel_err"],
        "per_c": {str(c): v for c, v in dense_c.items()}})
    head = ssd_t[f"{PREFILL[0]}x{PREFILL[1]}"]
    rows_out.append({
        "name": "ssd_scan", "route": "cuda", "source": SSD_TC_SRC,
        "replaces": SSD_REPLACES, "launches": mamba["launches"],
        "design": SSD_DESIGN, "tensor_core_launches": mamba["tc_launches"],
        "max_abs_err": max(ch["max_abs_err"] for ch in ssd_checks),
        "max_rel_err": max(ch["max_rel_err"] for ch in ssd_checks),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_at": {"B": PREFILL[0], "S": PREFILL[1], "H": 64, "P": 64,
                     "G": 1, "N": 128, "chunk": 256, "dtype": "bfloat16"},
        "checked": True, "launches_per_forward": mamba["launches"],
        "launches_per_rank_split_forward": split["17b"]["launches"],
        "heads_per_launch_split": split["17b"]["heads"],
        "split_forward": "{arch} 1 x 2 ranks, {prefill[0]} x "
                         "{prefill[1]}".format(**SPLIT17_FULL[0]),
        "launches_reduced_split_mesh": split["reduced"]["ssd"],
        "per_shape": ssd_t, "checks": ssd_checks})
    # the flash row: launches of the qwen2-7b kernel forward (phase 10, this
    # kernel's model path), timed at qwen2-7b's attention shape; each
    # model's launches a forward and device ms a call beside them
    head = flash_t[FLASH_CHECKS[0][0]]
    qwen = families["qwen2-7b"]
    per_forward = {arch: families[arch]["launches"]
                   for arch, *_ in FAMILIES}
    per_forward.update({f"{k} (reduced)": v["launches"]
                        for k, v in families["reduced"].items()})
    rows_out.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_TC_SRC,
        "replaces": FLASH_REPLACES, "launches": qwen["launches"],
        "design": "bf16 on the tensor cores (wgmma); f32 in "
                  f"{FLASH_SRC}: {FLASH_F32_DESIGN}",
        "tensor_core_launches": qwen["tc_launches"],
        "launches_per_forward": per_forward,
        "device_ms_per_call_in_models": {
            arch: families[arch]["flash_ms_per_call"]
            for arch, *_ in FAMILIES},
        "launches_mamba2_forward": mamba["flash_launches"],
        "max_abs_err": max(ch["max_abs_err"] for ch in flash_checks),
        "max_rel_err": max(ch["max_rel_err"] for ch in flash_checks),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": FLASH_CHECKS[0][0], "checked": True,
        "on_main_path": True, "per_shape": flash_t,
        "launches_per_rank_mesh_forward": tp["full"]["flash_launches"],
        "mesh_forward": f"{MESH14_ARCH} 1 x {MESH14_RANKS} ranks, "
                        f"{MESH14_PREFILL[0]} x {MESH14_PREFILL[1]}",
        "offset_launches_reduced_mesh": tp["offset_launches"],
        "launches_per_rank_split_mla_forward": split["17c"]["launches"],
        "heads_per_launch_split_mla": split["17c"]["heads"],
        "split_mla_forward": "{arch} cut to {over[num_layers]} layers, "
                             "1 x 2 ranks, {prefill[0]} x "
                             "{prefill[1]}".format(**SPLIT17_FULL[1]),
        "launches_reduced_split_mesh": split["reduced"]["flash"],
        "launches_per_rank_split_families": {
            f"{setup['arch']} ({setup['tag']})":
                split18[setup["tag"]]["launches"] for setup in SPLIT18_FULL},
        "heads_per_launch_split_families": {
            f"{setup['arch']} ({setup['tag']})":
                split18[setup["tag"]]["heads"] for setup in SPLIT18_FULL},
        "offset_checks": [ch for ch in flash_checks if "q_offset" in ch],
        "checks": flash_checks})
    # the FISTA row: launches of phase 3's training run (the main path),
    # checked and timed on that trainer's own Z_L inputs
    rows_out.append({
        "name": "fista_lanes", "route": "cuda", "source": FISTA_SRC,
        "replaces": FISTA_REPLACES, "design": FISTA_DESIGN,
        "layout": fista_t["layout"], "launches": fista_launches,
        "launches_per_step": fista_per_step,
        "max_abs_err": fista_t["max_abs_err"],
        "max_rel_err": fista_t["max_rel_err"],
        "ms": fista_t["ms"], "plain_ms": fista_t["plain_ms"],
        "bound_ms": fista_t["bound_ms"], "bound_by": fista_t["bound_by"],
        "library_ms": None, "timed_at": fista_t["timed_at"],
        "checked": True, "lip_bitwise": fista_t["lip_bitwise"],
        "bitwise_lanes": fista_t["bitwise_lanes"],
        "mflop": fista_t["mflop"], "mbytes": fista_t["mbytes"]})
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
