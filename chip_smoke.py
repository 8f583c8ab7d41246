"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. card: the GPU's name and power limit, from ``nvidia-smi``;
2. build: the six CUDA kernels from ``src/repro_torch/csrc/`` (one
   ``nvcc`` each, in parallel);
3. kernels: the paged kernels against their plain PyTorch versions on the
   card at the serving path's shapes (B=8, H=K=32, D=80, block 16, ragged
   lengths with 0 and a full row, unallocated table entries on the scratch
   row), plus a GQA case (K=8) and a windowed case, in bf16 and fp32
   (tolerance fp32 2e-5, bf16 2e-2; pools after the append bit-exact, at
   the decode step's C=1 and for a chunk of C=16 with ragged ``n_valid``,
   a row writing nothing and several tails on the scratch row),
   each decode case also bit-identical through a table of 256 blocks, one
   row alone and on a second launch, then a long context (T=4096) and
   h2o-danube's GQA window case (T=8192), every row full, timed beside the
   bound at the three shapes; ``branch_matmul`` against its plain version
   at the planner path's two sites (G=6, M=512, K=2560, N=240 and G=6,
   M=512, K=80, N=2560) in fp32 (CUDA cores) and bf16 (tensor cores),
   each also with per-group row counts (0 to M: rows below each count
   bit-identical to the launch without counts, rows past it exact
   zeros), and a ragged ``parallel_branches`` case (same tolerances; two
   launches bit-identical; per site, whether the kernel equals
   ``torch.bmm`` bit for bit); median times by CUDA events beside the
   bound and, for ``branch_matmul``, ``torch.bmm`` and, with counts,
   ``torch._grouped_mm`` on the routed rows where this torch has it and
   the routed-work bound; ``decode_attention`` on the model's
   ``(B, T, K, D)`` cache at the dense path's shape (B=8, H=K=32, D=80,
   T=160, tile 16) in bf16 and fp32, a GQA + window case at
   h2o-danube-3-4b widths (32/8 heads, D=120, window 4096, T=8192), a ring
   cache with permuted positions and T=4096, and bit-identical to
   ``paged_decode_attention`` on the same K/V laid into a block pool
   (windows 0 and 37), to itself over a cache of 4096 slots (empty past
   cache_len), one row alone and a second launch; ``flash_attention`` at
   the prefill shape (B=2, 32 heads, D=80, S=2048, causal) in bf16 and
   fp32, the h2o-danube window case (B=1, S=6144), a non-causal T > S
   case, a GQA 32/8 case at S = T = 1000 (off the 64-row tile) and rows
   with no valid key (S=32, T=8, window 4, causal or not, bf16 and fp32:
   the mean of V over all T keys), each launched twice and bit-identical
   — every bf16 attention case also normwise within 5e-3 of its plain
   version evaluated in fp32 on the same bf16 inputs — times beside
   their bounds and one ``scaled_dot_product_attention`` call
   each; ``ssd_scan`` (fp32) against its plain version and the sequential
   recurrence at rtol = atol = 2e-4 at the prefill shape (b=2, H=32,
   S=2048, chunk 256, P=64, N=128), a long prompt (b=1, S=8192), an odd
   chunk with groups broadcast by stride (S = L = 100, G=2, strided
   operands) and jamba-v0.1-52b's SSM widths (H=128, N=16), each bit for
   bit against a rerun, its last batch row alone and its first half of
   whole chunks alone, times beside the bound (no PyTorch call computes
   the scan);
4. serve: ``stablelm-3b`` at full width (32 layers, d_model 2560, bf16,
   random weights from ``torch.Generator`` seed 0) through
   ``ContinuousEngine`` with the paged pool, prefix sharing and megastep
   8: 8 seeded requests, prompts of 16-128 tokens (two share a 32-token
   prefix), 32 new tokens each.  Launch counts are zeroed just before
   and read just after: every ``decode_fn`` call must launch each kernel
   once per layer;
5. identity: the same workload at megastep 1 and with sharing off must
   give bit-identical greedy streams; then the dense-cache path: the
   same workload through ``ContinuousEngine(paged=False)`` at megastep 8
   and 1 and through the round engine ``ServingEngine`` (streams
   bit-identical to the paged run; a divergence is printed with the
   logits at its first step before the phase fails), each run with its
   launch counts
   zeroed just before and read just after: 32 ``decode_attention``
   launches per ``decode_fn`` call, none of the paged kernels; then
   ``prefill_fn`` on B=2, S=2048: 32 ``flash_attention`` launches per
   call and no decode kernel, logits within a normwise 2e-2 of the same call with the plain
   attention patched in (2e-4 in an fp32 model with the same weights),
   and on a 128-token prompt its argmax against the first token of
   ``Stepper.prefill_chunk`` on the dense cache (and, in fp32, its
   logits against scalar token-by-token decode at 2e-4);
6. reference: the reduced fp32 model on the card against the same
   weights on the CPU (plain versions), a few decode steps, fp32 2e-5;
   then where one full-width decode step spends its time, on the dense
   cache and the paged pool (host clock, ``torch.profiler``; device
   kernels per decode-attention wrapper call);
7. CLI: ``repro_torch.launch.serve.serve("stablelm-3b",
   engine_mode="continuous")`` on the card, then the entry point with
   ``--engine round`` and with ``--no-paged``;
8. planner A, the grouped kernel's path: ``torch_graph_zoo.multihead_graph
   (dim=2560, heads=32, seq=512)`` (one stablelm-3b attention layer at
   its widths, fp32) planned with the card's free memory as the §3.3
   budget, then run in every ``PlanExecutor`` mode.  Launch counts are
   zeroed just before and read just after: every fused run must launch
   ``branch_matmul`` once per GEMM site (2).  Kernel-off modes and the
   ``ArenaExecutor`` must be bit-identical to ``reference``.  The fused
   modes must match the same schedule run with the plain GEMM (cuBLAS
   ``bmm``) to rtol = atol = 2e-5, and ``reference`` to a normwise 1e-4:
   this graph's attention logits (std ~225) turn fp32 rounding into
   elementwise differences above 2e-5 between any two summation orders
   (normwise ~1e-5; an ordering or mapping fault would give ~1);
9. planner B, the model DAG: ``export_decoder_graph`` of stablelm-3b at
   full width, depth cut to 8 of its 32 layers (the later phases took
   the time; fp32 weights from ``torch.Generator`` seed 0), batch 1, seq
   256, through the planner and every mode; every mode's logits and the
   ``ArenaExecutor``'s bit-identical to ``reference`` (their distance to
   the op-by-op oracle printed);
10. mamba2 prefill: ``mamba2-370m`` at full width (48 Mamba2 layers,
    d_model 1024, d_state 128, bf16, random weights from
    ``torch.Generator`` seed 0), ``prefill_fn`` on B=2, S=2048: 48
    ``ssd_scan`` launches per call, logits against the same call with
    the plain scan patched in — at 2e-4 in an fp32 model with the same
    weights, and in bf16 at 4e-2 (this bf16 model moves its logits
    more than 2e-2 between two fp32 orders of the same scan: the plain
    version at chunk 128 against 256 must land inside it, and two
    deliberately perturbed scans outside), the cross-checks of phase 5 on a
    256-token prompt, the scan at layer 0's own inputs against the
    float64 recurrence, and profiles of one decode step and one prefill
    call (device kernels per ``ssd_scan`` call);
11. mamba2 serve: the 8-request workload through ``ContinuousEngine``
    (paged, megastep 8, sharing asked for and gated off; dense at
    megastep 8 and 1) and ``ServingEngine``: streams bit-identical, no
    ``ssd_scan`` launch in decode, reset dispatches counted; a request
    served in a slot after another equals its solo run; one poisoned
    megastep falls back and ends bit-identical to the clean run;
12. mamba2 planner: ``export_decoder_graph`` of mamba2-370m at full width
    and depth (fp32), batch 1, seq 256, through ``reference`` and fused
    ``parallax``: one ``ssd_scan`` launch per layer per run, logits
    within 2e-4 of the op-by-op oracle;
13. CLI: ``serve("mamba2-370m")`` and ``--arch mamba2-370m --engine
    round``;
14. MoE kernel cases: ``branch_matmul`` in bf16 at the MoE decode
    path's shapes — dbrx-132b (16 experts, d_model 6144, d_ff 10752) and
    kimi-k2 (384 experts, d_model 7168, d_ff 2048) at capacity 8 (B=8) —
    each twice, with every row counted and with the per-expert counts
    of a top-k routing of 8 tokens (the path's), each against its plain
    version with the same counts at 2e-2, bit-identical on a second
    launch, with 40 more rows a group (the same rows at another
    capacity, on another tile) and, below the counts, to the launch
    without counts, rows past the counts exact zeros; timed beside its
    padded and routed-work bounds, one ``torch.bmm`` call on the same
    padded tensors and one ``torch._grouped_mm`` call on the routed rows
    (the prefill shapes follow in 16 and 18);
15. dbrx-132b serve: full width, 8 of its 40 layers (54.6 GB of bf16
    weights; random, from ``torch.Generator`` seed 0; router fp32), the
    8-request workload through ``ContinuousEngine`` (paged, megastep 8,
    sharing), launch counts zeroed just before and read just after: per
    ``decode_fn`` call 3 ``branch_matmul`` launches per layer (the
    dropless expert GEMMs of ``moe_ragged``) and one of each paged
    kernel; streams bit-identical at megastep 1, sharing off, on the
    dense cache (N=8 and 1), and compared through ``ServingEngine``;
16. dbrx-132b ``prefill_fn`` at B=1, S=2048: 24 ``branch_matmul`` and 8
    ``flash_attention`` launches a call; layer 0's MoE at its own inputs
    against ``moe_ragged`` with ``branch_matmul_plain`` patched in (2e-2,
    routing equal), its dropless capacity and its rows in the buckets,
    computed in row tiles and routed printed, and its three
    ``branch_matmul`` launches at that capacity on its bucketed rows with
    its counts as in 14; the logits against the plain-GEMM call (normwise 2e-2, the
    tokens routed to other experts counted per layer with their
    probability gaps); profiles of the call and of one decode step
    (dense and paged); then an fp32 model at full width, 2 layers, the
    same against the plain GEMM at 2e-4;
17. the MoE DAG: ``export_decoder_graph`` of that fp32 model (a router
    node marked unsupported, 16 expert chains and a combine a layer),
    batch 1, seq 128, through the planner, ``reference`` and fused
    ``parallax`` within 2e-4 of the op-by-op oracle, branches a layer and
    schedule widths printed; the expert chains run branch by branch (no
    GEMM site: their nodes are not pure 2-D matmuls), and every run's
    ``branch_matmul`` launches equal its schedule's GEMM sites (0);
18. kimi-k2: full width, 2 of 61 layers (the dense first layer and one
    384-expert layer with the shared expert), bf16: one ``prefill_fn``
    call (B=1, S=2048; 3 ``branch_matmul`` and 2 ``flash_attention``
    launches), its MoE layer at its own inputs against the plain GEMM
    with its three launches at the prefill's capacity (as in 16) and on
    16 tokens against ``moe_dense`` (every expert; normwise 2e-2),
    profiles of a prefill call and a decode step, and the paged serve run
    (megastep 8) with its launch counts;
19. CLI: ``serve("dbrx-132b")`` and ``--arch kimi-k2-1t-a32b --requests
    4 --max-new 8`` (the reduced configs, 4 experts: ``moe_dense``);
20. the heterogeneous runtime, ``PlanExecutor(mode="parallax-hetero")``
    with the host CPU beside the card, every graph input passed as a
    host numpy array, in five parts run beside the phases whose graphs
    they reuse.  First (after 8) the two constants of
    ``core.partition.H100`` no data sheet gives, printed on the "h100
    profile" line: the dispatch latency L (median host time of a tiny
    launch plus a 4-byte copy back) and the host's fallback rate R_cpu
    (an fp32 1024^3 CPU matmul).  Hetero A: planner A's graph placed
    under the permissive profile and under ``H100_CONFIG``: every branch
    on the card, bit-identical to fused ``parallax``, 2 ``branch_matmul``
    launches a run.  Hetero B: ``heterogeneous_graph``, ``cond_graph``
    and ``while_graph`` at dim 2560 under ``H100_CONFIG``: the
    control-flow nodes on the host as dynamic regions, within rtol =
    atol = 2e-5 of ``reference`` on the card (normwise distance
    printed), the region cache hit on every later run.  Hetero C (after
    9): planner B's stablelm-3b DAG under ``MOBILE_CONFIG`` and
    ``H100_CONFIG``: branches per device per model layer, segments,
    transfers by direction, wall ms a run beside fused ``parallax``
    (all on the card) and a run with a barrier after each segment split
    by device; logits within a normwise 1e-4 of ``reference``, argmax
    equal.  Hetero E (after 12): mamba2-370m's DAG cut to 8 of its 48
    layers for the script's time: the scan chains on the host, 0
    ``ssd_scan`` launches a hetero run (one a layer in fused
    ``parallax``), logits within 2e-4 of the oracle.  Hetero D (after
    17): the fp32 MoE DAG, each router a host dynamic region, logits
    within 2e-4 of the oracle.  Every run has one sync, moves exactly
    ``physical_bytes()`` of the plan's transfers, counts every dispatch
    on a device and repeats the first run bit for bit (3 runs a case).
    The params are graph inputs and move to their consumers' devices
    every run without being counted as transfers, as in the JAX
    runtime; the printed times include those copies.

21. Whisper kernel cases (right after 3): ``flash_attention`` at
    whisper-tiny's encoder shape (B=8, H=K=6, D=64, S=T=1500,
    non-causal: both tiles partial) in bf16 and fp32, and
    ``decode_attention`` at the decoder's cross shape (T=1500 encoder
    positions, every slot valid, 94 tiles of 16) and self shape (448
    slots, cache_len 100), each against its plain version, launched twice
    and bit-identical, each decode row alone (B=1) bit-identical to its
    row in the batch of 8, timed beside its bound and one SDPA call (no
    mask for the cross case), and ``flash_attention`` at S=1 on the
    cross shape timed beside it (the path not taken);
22. whisper-tiny at full width (4 + 4 layers, d_model 384, bf16, random
    weights from ``torch.Generator`` seed 0; last, after 19): on 8 stub
    utterances of 1500 frames, ``prefill_fn`` with 4 ``flash_attention``
    and 8 ``decode_attention`` launches a call (every count set to 0
    just before and read just after), logits within a normwise 2e-2 of
    the same call with both plain versions patched in (2e-4 in an fp32
    model with the same weights); 32 greedy tokens each through
    ``decode_fn`` after ``encdec.prefill_encdec``, with a scalar and
    with a vector ``cache_len``: 8 ``decode_attention`` launches a call
    and no other kernel, streams bit-identical, the first step's logits
    bit-identical to ``prefill_fn``'s, tok/s, ms a step and peak memory
    printed; profiles of a prefill call and a decode step; the reduced
    fp32 model on the card against the CPU (prefill and 4 decode steps,
    2e-5); the encoder DAG (``export_encoder_graph``, fp32, batch 1, seq
    1500) through every planner mode and ``ArenaExecutor``,
    bit-identical to ``reference``, then hetero F: the DAG under
    ``MOBILE_CONFIG`` and ``H100_CONFIG`` in ``parallax-hetero`` (its
    RoPE'd attention chains on the host), within a normwise 1e-5 of
    ``reference``.  Whisper's launch counts print on a line of their own
    before the ``kernels`` line.

23. training, kernel gradients (last, after 22): each differentiable
    kernel's ``autograd.Function`` (its forward is the wrapper, its
    backward autograd of the plain version on the saved inputs) at the
    training path's shapes: ``flash_attention`` bf16 at stablelm-3b's
    prefill shape (B=2, H=K=32, D=80, S=2048, causal), whisper-tiny's
    encoder (B=8, H=K=6, D=64, S=T=1500) and cross shape (B=4, S=128
    against T=1500), ``ssd_scan`` fp32 at mamba2-370m's (b=2, S=2048,
    H=32, P=64, N=128, chunk 256), ``branch_matmul`` bf16 at dbrx's
    gate/up widths with a top-4 routing's counts over 512 tokens: the
    forward bit-identical to the bare kernel, every gradient
    bit-identical to autograd's of the plain version, the bare wrapper
    refusing an input that requires grad, the rows past the counts with
    zero gradient; the forward, and forward + backward of the Function,
    the plain version and SDPA / ``torch.bmm`` timed beside a bound;
24. stablelm-3b at full width (32 layers, B=8, S=128), 25. mamba2-370m
    (48 layers, B=4, S=512) and 26. whisper-tiny (4 + 4 layers, B=4,
    1500 frames, 128 tokens), each in bf16 with AdamW on fp32 masters
    (lr 3e-3) on ``SyntheticTokens(seed=0)``: step 1's loss and
    gradient norm through the kernels against the same with the three
    plain versions patched in (normwise 2e-2), one train step profiled
    (busy and idle share), then ``launch.train.train(..., reduced=
    False)`` for 5 steps: every loss and grad_norm finite, each step
    launching every kernel of a layer twice (forward and remat
    recompute; whisper's encoder once: 64, 96 and 20 a step), step 1
    bit-identical to the checked step, ms a step, tokens/s and peak
    memory printed; then the kimi-like reduced MoE in bf16 (4
    ``flash_attention`` and 6 ``branch_matmul`` a step; no full-width MoE
    layer trains on one card), and ``python -m repro_torch.launch.train
    --arch stablelm-3b --full --steps 3``;
27. ``examples/torch_train_small.py``: reduced stablelm-3b, 200 steps,
    the loss below 0.7x its first value, the checkpoint restored bit
    for bit.  The ``kernels`` line gains three rows,
    ``flash_attention_grad``, ``ssd_scan_grad`` and
    ``branch_matmul_grad``: forward + backward times (``fwd_ms`` the
    forward), launches in the stablelm-3b, mamba2-370m and MoE training
    runs.

28.-33. qwen2-vl-2b at full width (28 layers, d_model 1536, GQA 12/2
    heads of 128, M-RoPE sections (16, 24, 24), bf16, random weights from
    ``torch.Generator`` seed 0; after 22, before 23): 28. the attention
    kernels at its shapes through phase 3's cases: ``flash_attention`` at
    B=2, S=T=2048, causal, the decode kernels at B=8 over 160 slots (a
    dense cache and a block pool of the same K/V) and ``paged_append``
    (C=1), in bf16 and fp32, each against its plain version (bf16 also
    normwise within 5e-3 of the plain version in fp32), launched twice
    bit-identical, the decode kernels bit for bit against each other and
    a row alone, bf16 timed beside the bound and SDPA (``enable_gqa``);
    29. phase 5's prefill checks on B=2 rows of 1024 stub vision patches
    (``stub_vision_frontend``) and 1024 text tokens with 3-stream
    positions: 28 ``flash_attention`` launches a call and no other kernel,
    logits within a normwise 2e-2 of the plain version patched in (2e-4
    in an fp32 model with the same weights), two planted faults outside
    2e-2 (the M-RoPE sections reversed to (24, 24, 16); query head h on
    KV head h % K), a text-only 128-token prompt (``positions3`` =
    arange on every stream) against scalar token-by-token decode (fp32
    2e-4, bf16 5e-2) and ``Stepper.prefill_chunk``, a profile of the
    call; 30. phases 4-5b's serving checks: 28 ``paged_append`` and 28
    ``paged_decode_attention`` launches a ``decode_fn`` call, streams
    bit-identical at megastep 1, sharing off, on the dense cache (N=8 and
    1; 28 ``decode_attention`` a call) and through the round engine; one
    call with explicit ``positions3`` equal to ``cache_len`` bit-identical
    to the call without, paged and dense; profiles of a decode step on
    the dense cache and the paged pool; 31. training:
    ``make_train_step`` at B=4 of 1024 vision + 1024 text positions
    (labels for the text), step 1 against the plain versions with the
    planted faults caught, 56 ``flash_attention`` launches a step, 3
    steps with peak memory, a profiled step; 32.-33. the DAG
    (``export_graph``, fp32, all 28 layers, batch 1, seq 256: JAX's graph
    has plain RoPE, no QKV bias and no frontend) through every planner
    mode and ``ArenaExecutor`` bit-identical to ``reference``, then hetero
    G: ``parallax-hetero`` under ``MOBILE_CONFIG`` and ``H100_CONFIG``
    within a normwise 1e-4 of ``reference``, argmax equal.  Qwen2-VL's
    launch counts print on a line of their own before the ``kernels``
    line.

34.-36. the distributed layer (after 33, before 23): 34. chunked
    attention at stablelm-3b's widths (B=1, H=K=32, D=80, S=4096, causal,
    bf16): ``attend_chunked`` (chunks 512/1024, plain torch on the card)
    and the ``flash_attention`` kernel, each normwise within 5e-3 of the
    plain version in fp32 on the same bf16 inputs, both timed beside one
    SDPA ``is_causal`` call on the same inputs; with
    ``runtime_flags.chunked_attention`` on, ``self_attention`` at full
    width still launches the kernel once (counted) and equals the call
    with the flag off bit for bit; 35. ``moe_ep`` at dbrx-132b's widths
    (d=6144, f=10752, E=16, top-4, one MoE layer, bf16) on a (1, 1) mesh
    over a one-rank NCCL group: the replicated regime at T=4 against
    ``moe_ragged`` (routing equal, outputs within 2e-2) and the a2a
    regime at T=2048 against the same call on the plain GEMM, 3
    ``branch_matmul`` launches a call (its own counter), each timed
    beside the same call on the plain GEMM and ``moe_ragged``; 36. the
    dry-run (``repro_torch.launch.dryrun``, fake tensors, nothing
    allocated) in child processes that start after phase 35's timing,
    so no child competes with the timed host work: dbrx-132b ``decode_32k`` (through ``moe_ep``),
    jamba-v0.1-52b ``long_500k`` and stablelm-3b ``train_4k`` on the
    16x16 mesh, per-device GiB against the card's 80 GB, the three
    roofline terms (modelled from the data sheet) and collective bytes by
    op; then calibration: stablelm-3b ``prefill_fn`` at B=1, S=4096 with
    the chunked flag on, dry-run on a (1, 1) fake mesh and run for real on
    the card: the predicted argument bytes must equal the bytes of the
    inputs on the card; the predicted peak is printed beside
    ``torch.cuda.max_memory_allocated()``.  Their launch counts print on
    a "distributed launches per call" line before the ``kernels`` line.

dbrx-132b and kimi-k2 are never resident together, nor beside another
full-width model: each is freed before the next is built.

The last three lines are the ``kernels`` JSON object, the card's name
and power limit, and the result object ``{"ok": true, "device":
{...}}``.  Without a card, or without
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 attention kernels against the plain version evaluated in fp32 on
# the same bf16 inputs: the output's own rounding reads about 2e-3; keys
# of a partial tile that leaked in with weight exp(0) would shrink
# Whisper's 1500-key encoder rows by ~1.5 % and read ~1.5e-2
BF16_NORMWISE = 5e-3
B, H, D, BS = 8, 32, 80, 16        # the full-width main path's shapes
PROMPT_MIN, PROMPT_MAX, MAX_NEW, PREFIX = 16, 128, 32, 32
MAX_CONTEXT = PROMPT_MAX + MAX_NEW
BPR = -(-MAX_CONTEXT // BS)        # blocks per row at that context
SPIN_CYCLES = 2_000_000            # ~1 ms: covers one wrapper's host time

BM_SITES = {"qkv": (6, 512, 2560, 240), "out": (6, 512, 80, 2560)}
BM_COUNTS = (512, 300, 0, 17, 511, 256)     # per-group rows at the sites
PLANNER_GRAPH = dict(dim=2560, heads=32, seq=512)
DAG_BATCH, DAG_SEQ = 1, 256
DAG_LAYERS = 8                     # planner B's stablelm-3b depth (of 32)
RUNS_A, RUNS_B = 15, 3             # timed runs per planner mode
MODES = {                          # PlanExecutor keyword arguments
    "reference": dict(mode="reference"),
    "sequential": dict(mode="sequential"),
    "interpreted": dict(fused=False),
    "fused": dict(),
    "whole_plan": dict(whole_plan=True),
    "fused, kernel off": dict(use_branch_kernel=False),
}
PLANNER_MODES = {k: MODES[k] for k in ("reference", "fused")}  # DAG phases

# the dense-cache and prefill phases (slice 3)
DA_LONG_T = 4096                   # decode_attention at a long context
DANUBE = dict(H=32, K=8, D=120, window=4096)   # h2o-danube-3-4b widths
FA_B, FA_S = 2, 2048               # flash_attention at the prefill shape
FA_WINDOW_S = 6144                 # h2o-danube window case, B=1
FA_CROSS = dict(B=2, S=448, T=1500)            # causal=False, T > S
FA_OFF_TILE = dict(S=1000, K=8)    # S = T off the 64-row tile, GQA 32/8
FA_EMPTY = dict(S=32, T=8, window=4)           # rows 11.. have no valid key
PREFILL_B, PREFILL_S, PREFILL_RUNS = 2, 2048, 5
# where attend_bshd looks the kernel up: the module to patch its plain
# version into
FLASH_MODULE = "repro_torch.kernels.flash_attention.flash_attention"
XCHECK_PROMPT = 128                # prefill_fn vs the stepper's prefill
# prefill logits vs other paths: normwise (||a - b|| / ||b||), bf16 model
PREFILL_TOL = 2e-2                 # kernel vs plain version, bf16 model
PREFILL_TOL_FP32 = 2e-4            # the same in an fp32 model
XCHECK_TOL = 5e-2                  # prefill_fn vs token-by-token decode
# mamba2-370m in bf16, normwise from the plain path (H100 80GB HBM3,
# 700 W): sound scans read 3.411e-2 (the plain version at chunk 128) and
# 3.485e-2 (the kernel); faulty ones 4.476e-2 (y rounded to bf16) and
# 4.488e-2 (dt rounded to bf16).  The limit lies between the two.
MAMBA_PREFILL_TOL = 4e-2

# the Mamba2 phases (slice 4): mamba2-370m's SSD widths
SSD_P, SSD_N, SSD_TOL = 64, 128, 2e-4
SSD_CASES = (                      # label, b, S, H, G, L, N, strided
    ("prefill shape", PREFILL_B, PREFILL_S, 32, 1, 256, SSD_N, False),
    ("long prompt", 1, 8192, 32, 1, 256, SSD_N, False),
    ("odd L = S, G=2", 2, 100, 32, 2, 100, SSD_N, True),
    # jamba-v0.1-52b's SSM: d_state 16, 8192 / 64 heads, chunk 256
    ("jamba shape", 2, 2048, 128, 1, 256, 16, False),
)
APPEND_CHUNK = 16                  # paged_append's chunked, ragged case
MAMBA_XCHECK = 256                 # one chunk: prefill_fn needs S % 256
MAMBA_RUNS = 3                     # timed runs per planner mode
MAMBA_HETERO_LAYERS = 8            # hetero E's mamba2-370m depth (of 48)

# the MoE phases (slice 5): published widths, depth cut to fit one card
DBRX_LAYERS = 8                    # of 40: 54.6 GB of bf16 weights
DBRX_FP32_LAYERS = 2               # the fp32 check and the MoE DAG: ~31 GB
KIMI_LAYERS = 2                    # dense layer 0 + one 384-expert layer
MOE_PREFILL_B = 1                  # S = PREFILL_S: ~3.3e12 FLOP of experts
MOE_PREFILL_RUNS = 2               # timed prefill_fn calls (~1-2 s each)
MOE_DAG_SEQ = 128
MOE_KERNEL_ITERS = 10              # timed launches per MoE kernel case
MOE_EXTRA_ROWS = 40                # the same rows at a second capacity
MOE_CASES = (                      # label, G, M (capacity = B), K, N, top-k
    ("dbrx decode gate/up", 16, B, 6144, 10752, 4),
    ("dbrx decode down", 16, B, 10752, 6144, 4),
    ("kimi decode gate/up", 384, B, 7168, 2048, 8),
    ("kimi decode down", 384, B, 2048, 7168, 8),
)

# the heterogeneous runtime (slice 6)
HETERO_RUNS = 3                    # parallax-hetero runs a case, identical
HETERO_LAT_ITERS = 200             # launch + copy round trips for L
HETERO_CPU_MM = 1024               # the fp32 CPU matmul for R_cpu
HETERO_CF_GRAPHS = ("heterogeneous", "cond", "while")
HETERO_CF_DIM = 2560               # hetero B's width, stablelm-3b's d_model
HETERO_NORMWISE = 1e-4             # hetero C: CPU against card fp32 sums

# the Whisper phases (slice 7): whisper-tiny's widths, 8 utterances
WHISPER = dict(B=8, H=6, D=64, T_ENC=1500, T_DEC=448)
WHISPER_SELF_LEN = 100             # decode_attention's self case
WHISPER_NEW = 32                   # greedy tokens an utterance
WHISPER_SOT = 50258                # <|startoftranscript|>
WHISPER_REF_STEPS = 4
WHISPER_NORMWISE = 1e-5            # hetero F: CPU against card fp32 sums

# the Qwen2-VL phases (slice 9): qwen2-vl-2b's widths, 28 layers
QWEN = dict(H=12, K=2, D=128)      # GQA 12/2 heads of 128
QWEN_TRAIN_B, QWEN_TRAIN_STEPS = 4, 3
QWEN_DAG_SEQ = 256

# the training phases (slice 8)
GRAD_FLASH = (                     # label, B, H, K, S, T, D, causal
    ("stablelm-3b prefill", 2, 32, 32, 2048, 2048, 80, True),
    ("whisper encoder", 8, 6, 6, 1500, 1500, 64, False),
    ("whisper cross", 4, 6, 6, 128, 1500, 64, False),
)
GRAD_SSD = dict(b=2, S=2048, H=32, G=1, N=128, L=256)    # mamba2-370m
GRAD_GEMM = dict(E=16, k=4, T=512, d=6144, f=10752)      # dbrx gate/up
GRAD_ITERS = 10                    # timed forward (+ backward) calls
TRAIN_RUNS = (                     # arch, batch, seq: full width
    ("stablelm-3b", 8, 128),
    ("mamba2-370m", 4, 512),
    ("whisper-tiny", 4, 128),
)
TRAIN_STEPS, TRAIN_LR = 5, 3e-3
# step 1's loss and grad_norm through the kernels against the plain
# versions, relative: ~10x the largest reading of the first chip run
# (H100 80GB HBM3, 700 W: loss 7.6e-5, grad_norm 1.8e-4)
TRAIN_TOL = 2e-3
GRAD_BF16_NORMWISE = BF16_NORMWISE  # a bf16 Function's output
GRAD_FP32_NORMWISE = 2e-5                   # the fp32 scan's
# step 1's worst leaf gradient, normwise against the plain versions':
# sound runs read 2.2e-2 to 1.2e-1, the planted faults 0.82 to 1.7
LEAF_TOL = 0.5
# planted faults (``faulty_kernels``): flash_attention with window
# FAULT_WINDOW (keys more than 32 behind a query masked out), ssd_scan
# with each token's own term dropped (a strictly causal mask) or
# restarting every chunk from a zero state (the state pass dropped),
# branch_matmul one row short in every group.  The kernel checks must
# catch each, step 1's checks all but the restart: at random init
# mamba2-370m's state decays within a chunk, and step 1 moved 1.5e-5,
# 2.5e-5 and 0.16 (worst leaf), so that one is read and not held
# (readings on an H100 80GB HBM3 at 700 W)
FAULT_WINDOW = 32
FUNCTIONS = {"flash_attention": "FlashAttentionFn", "ssd_scan": "SSDScanFn",
             "branch_matmul": "BranchMatmulFn"}
LEARN_STEPS = 200                  # examples/torch_train_small.py

KERNELS = {
    "paged_decode_attention": dict(
        source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:88"),
    "paged_append": dict(
        source="src/repro_torch/csrc/paged_append.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:159"),
    "branch_matmul": dict(
        source="src/repro_torch/csrc/branch_matmul.cu",
        replaces="src/repro/kernels/branch_matmul/branch_matmul.py:45"),
    "decode_attention": dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:72"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:77"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:70"),
}


T_START = time.perf_counter()


def log(*args):
    """Print with the seconds since the script started, so a run shows
    where its time limit goes."""
    print(f"[{time.perf_counter() - T_START:6.1f} s]", *args, flush=True)


def median_ms(fn, flush, iters=50):
    """Median of per-launch CUDA-event times, L2 flushed before each
    launch (the serving path reaches each layer's pools cold).  A spin
    kernel ahead of the start event keeps the card busy while the host
    runs the wrapper, so the events bracket device time only (a plain
    version that syncs the host still shows its stalls)."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def decode_case(rng, K, dtype, device):
    nb = B * BPR
    pool = (nb + 1, BS, K, D)
    k_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    v_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=dtype,
                     device=device)
    tables = rng.permutation(nb).reshape(B, BPR).astype(np.int32)
    lens = rng.integers(0, BPR * BS, B).astype(np.int32)
    lens[0], lens[-1] = 0, BPR * BS - 1            # empty and full rows
    for b in range(B):
        tables[b, lens[b] // BS + 1:] = nb         # unallocated: scratch
    return (q, k_pool, v_pool, torch.tensor(tables, device=device),
            torch.tensor(lens, device=device))


def decode_bound(q, k_pool, lens, window):
    """Bytes the function must move: q, the valid K/V positions of each
    row, the table entries of the blocks that hold them, the lengths, the
    output."""
    B_, H_, D_ = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    item = q.element_size()
    hi = lens.long()
    lo = (hi - window + 1).clamp(min=0) if window > 0 else hi * 0
    n_tok = int((hi - lo + 1).sum())
    n_blk = int((hi // bs - lo // bs + 1).sum())
    nbytes = (2 * q.numel() * item + 2 * n_tok * K * D_ * item
              + 4 * n_blk + 4 * B_)
    flops = 4 * n_tok * H_ * D_
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def long_paged_case(gen, H_, K, D_, bpr, dtype, device):
    """q and pools of B rows with ``bpr`` blocks each, every row full
    (cache_len = bpr * bs - 1); values from the card's generator."""
    nb = B * bpr
    k_pool, v_pool = (torch.randn(nb + 1, BS, K, D_, generator=gen,
                                  device=device, dtype=dtype)
                      for _ in range(2))
    q = torch.randn(B, H_, D_, generator=gen, device=device, dtype=dtype)
    tables = torch.randperm(nb, generator=gen, device=device).reshape(
        B, bpr).int()
    lens = torch.full((B,), bpr * BS - 1, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, tables, lens


def identical(name, label, a, b):
    same = torch.equal(a, b)
    log(f"{name} {label}: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: {label} not bit-identical")


def paged_identities(pa, q, kp, vp, tables, lens, window, rng):
    """The same rows through a table of 256 blocks (the extra entries on
    random pool rows, past every cache_len), one row alone, and a second
    launch: the same bits."""
    dt = str(q.dtype)[6:]
    tag = f"{dt} K={kp.shape[2]} window={window}"
    got = pa.paged_decode_attention(q, kp, vp, tables, lens, window=window)
    extra = torch.tensor(rng.integers(0, kp.shape[0], (B, 256 - BPR)),
                         dtype=torch.int32, device=q.device)
    wide = torch.cat([tables, extra], 1)
    identical("paged_decode_attention", f"{tag}, bpr {BPR} vs 256", got,
              pa.paged_decode_attention(q, kp, vp, wide, lens,
                                        window=window))
    identical("paged_decode_attention", f"{tag}, two launches", got,
              pa.paged_decode_attention(q, kp, vp, tables, lens,
                                        window=window))
    for b in (0, 3, B - 1):
        one = pa.paged_decode_attention(q[b:b + 1], kp, vp,
                                        tables[b:b + 1], lens[b:b + 1],
                                        window=window)
        identical("paged_decode_attention",
                  f"{tag}, row {b} alone vs in the batch of {B}", one[0],
                  got[b])


def append_case(rng, dtype, device, C=1, K=H, D_=D):
    """The decode step's append (C = 1, row 3 idle) or a chunked one
    (C > 1): ragged ``n_valid`` with row 3 writing nothing and row 5 a
    full chunk, several rows sending their tails to the scratch row."""
    nb = B * BPR
    pool = (nb + 1, BS, K, D_)
    k_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    v_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    k_new = torch.tensor(rng.standard_normal((B, C, K, D_)), dtype=dtype,
                         device=device)
    v_new = torch.tensor(rng.standard_normal((B, C, K, D_)), dtype=dtype,
                         device=device)
    tables = torch.tensor(rng.permutation(nb).reshape(B, BPR)
                          .astype(np.int32), device=device)
    lens = torch.tensor(rng.integers(0, BPR * BS - C + 1, B)
                        .astype(np.int32), device=device)
    n_valid = torch.tensor(rng.integers(1, C + 1, B).astype(np.int32),
                           device=device)
    n_valid[3] = 0                                  # an idle row: scratch
    n_valid[5] = C
    return k_pool, v_pool, k_new, v_new, tables, lens, n_valid


def paged_timing(pa, label, q, kp, vp, tables, lens, window, flush):
    t = dict(ms=median_ms(lambda: pa.paged_decode_attention(
                 q, kp, vp, tables, lens, window=window), flush),
             plain_ms=median_ms(lambda: pa.paged_decode_attention_plain(
                 q, kp, vp, tables, lens, window), flush),
             bound=decode_bound(q, kp, lens, window))
    log(f"paged_decode_attention {label}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
        f"({t['bound'][1]})")
    return t


def kernel_phase(pa, device):
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    err = {name: 0.0 for name in KERNELS}
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        for K, window in ((H, 0), (8, 0), (H, 37)):
            q, kp, vp, tables, lens = decode_case(rng, K, dtype, device)
            got = pa.paged_decode_attention(q, kp, vp, tables, lens,
                                            window=window)
            want = pa.paged_decode_attention_plain(q, kp, vp, tables, lens,
                                                   window)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            log(f"paged_decode_attention {str(dtype)[6:]} H={H} K={K} "
                f"window={window}: max abs err {e:.3e} (tol {TOL[dtype]})")
            if not e <= TOL[dtype]:
                raise AssertionError("paged_decode_attention disagrees "
                                     "with its plain version")
            err["paged_decode_attention"] = max(
                err["paged_decode_attention"], e)
            paged_identities(pa, q, kp, vp, tables, lens, window, rng)
            if dtype == torch.bfloat16 and K == H and window == 0:
                timing["paged_decode_attention"] = paged_timing(
                    pa, "main path", q, kp, vp, tables, lens, 0, flush)
        # a long context and h2o-danube widths, every row full
        gen = torch.Generator(device=device).manual_seed(1)
        dn = DANUBE
        for label, H_, K, D_, bpr, window in (
                (f"T={DA_LONG_T} full", H, H, D, DA_LONG_T // BS, 0),
                (f"GQA {dn['H']}/{dn['K']} D={dn['D']} T=8192 "
                 f"window={dn['window']}", dn["H"], dn["K"], dn["D"],
                 8192 // BS, dn["window"])):
            q, kp, vp, tables, lens = long_paged_case(gen, H_, K, D_, bpr,
                                                      dtype, device)
            got = pa.paged_decode_attention(q, kp, vp, tables, lens,
                                            window=window)
            want = pa.paged_decode_attention_plain(q, kp, vp, tables, lens,
                                                   window)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            log(f"paged_decode_attention {str(dtype)[6:]} {label}: max abs "
                f"err {e:.3e} (tol {TOL[dtype]})")
            if not e <= TOL[dtype]:
                raise AssertionError("paged_decode_attention disagrees "
                                     "with its plain version")
            err["paged_decode_attention"] = max(
                err["paged_decode_attention"], e)
            if dtype == torch.bfloat16:
                paged_timing(pa, label, q, kp, vp, tables, lens, window,
                             flush)
            del q, kp, vp, got, want
            torch.cuda.empty_cache()
        for C in (APPEND_CHUNK, 1):
            k1, v1, kn, vn, tables, lens, nv = append_case(rng, dtype,
                                                           device, C)
            k2, v2 = k1.clone(), v1.clone()
            pa.paged_append(k1, v1, kn, vn, tables, lens, nv)
            pa.paged_append_plain(k2, v2, kn, vn, tables, lens, nv)
            torch.cuda.synchronize()
            exact = torch.equal(k1, k2) and torch.equal(v1, v2)
            log(f"paged_append {str(dtype)[6:]} B={B} C={C} K={H} D={D}, "
                f"n_valid {nv.tolist()}: pools "
                f"{'bit-identical' if exact else 'DIFFER'}")
            if not exact:
                raise AssertionError("paged_append disagrees with its plain "
                                     "version")
        if dtype == torch.bfloat16:
            nbytes = 4 * kn.numel() * kn.element_size() + 4 * B * 3
            timing["paged_append"] = dict(
                ms=median_ms(lambda: pa.paged_append(
                    k1, v1, kn, vn, tables, lens, nv), flush),
                plain_ms=median_ms(lambda: pa.paged_append_plain(
                    k2, v2, kn, vn, tables, lens, nv), flush),
                bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    for name, t in timing.items():
        log(f"{name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}) at the "
            f"main-path shape, bf16")
    return err, timing


# --------------------------------------------------------------------------
# phase 3c: decode_attention and flash_attention against their plain
# versions, the paged kernel and SDPA
# --------------------------------------------------------------------------

def dense_decode_case(rng, B_, H_, K, D_, T, dtype, device, lens=None):
    """q and a (B, T, K, D) cache seen as (B, K, T, D), the model's
    layout; ragged lengths with an empty and a full row by default."""
    q = torch.tensor(rng.standard_normal((B_, H_, D_)), dtype=dtype,
                     device=device)
    k, v = (torch.tensor(rng.standard_normal((B_, T, K, D_)), dtype=dtype,
                         device=device).transpose(1, 2) for _ in range(2))
    if lens is None:
        lens = rng.integers(0, T, B_).astype(np.int32)
        lens[0], lens[-1] = 0, T - 1
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)


def dense_decode_bound(q, k, pos, lens, window):
    """Bytes the function must move: q, the valid K/V slots of each row,
    pos, the lengths, the output; operations: 4 * D per (head, valid
    slot)."""
    B_, H_, D_ = q.shape
    K = k.shape[1]
    item = q.element_size()
    valid = (pos[None, :] >= 0) & (pos[None, :] <= lens[:, None])
    if window > 0:
        valid &= pos[None, :] > lens[:, None] - window
    n_tok = int(valid.sum())
    nbytes = (2 * q.numel() * item + 2 * n_tok * K * D_ * item
              + 4 * pos.numel() + 4 * B_)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n_tok * H_ * D_ / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_decode(q, k, v, pos, lens, window):
    """The library yardstick: one scaled_dot_product_attention call with
    the validity mask."""
    import torch.nn.functional as F

    valid = (pos[None, :] >= 0) & (pos[None, :] <= lens[:, None])
    if window > 0:
        valid &= pos[None, :] > lens[:, None] - window
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=valid[:, None, None, :],
        enable_gqa=True)[:, :, 0]


def flash_pairs(S, T, causal, window):
    """Valid (query, key) pairs of one head."""
    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound(q, k, causal, window):
    B_, H_, S, D_ = q.shape
    T = k.shape[2]
    item = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * item
    flops = 4 * D_ * flash_pairs(S, T, causal, window) * B_ * H_
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_flash(q, k, v, causal, window):
    import torch.nn.functional as F

    S, T = q.shape[2], k.shape[2]
    if window == 0:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def check(name, label, got, want, dtype):
    e = (got.float() - want.float()).abs().max().item()
    log(f"{name} {label} {str(dtype)[6:]}: max abs err {e:.3e} (tol "
        f"{TOL[dtype]})")
    if not e <= TOL[dtype]:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label})")
    return e


def bf16_vs_fp32(name, label, got, plain, *args):
    """A bf16 result against ``plain`` in fp32 on the same bf16 values:
    normwise within ``BF16_NORMWISE`` (nothing to check in fp32)."""
    if got.dtype != torch.bfloat16:
        return
    rel = normwise(got, plain(*(a.float() if a.is_floating_point() else a
                                for a in args)))
    log(f"{name} {label} bfloat16: normwise {rel:.3e} against the plain "
        f"version in fp32 on the same bf16 inputs (tol "
        f"{BF16_NORMWISE})")
    if not rel <= BF16_NORMWISE:
        raise AssertionError(f"{name} off the fp32 evaluation of its bf16 "
                             f"inputs ({label})")


def time_case(name, label, kernel, plain, library, bound, flush):
    t = dict(ms=median_ms(kernel, flush), plain_ms=median_ms(plain, flush),
             library_ms=median_ms(library, flush), bound=bound)
    log(f"{name} {label}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
        f"{bound[0]:.5f} ms ({bound[1]})")
    return t


class AttentionCases:
    """The dense attention kernels' cases, shared by the phases that run
    them at a model's shapes.  Each case is held to its plain version at
    ``TOL`` (bf16 also normwise within ``BF16_NORMWISE`` of the
    plain version in fp32 on the same bf16 inputs) and to itself across
    two launches, and timed beside its bound and one SDPA call where
    ``timed`` is given; ``err`` keeps each kernel's worst max abs err."""

    def __init__(self, pa, da, fa, rng, flush):
        self.pa, self.da, self.fa = pa, da, fa
        self.rng, self.flush, self.device = rng, flush, flush.device
        self.err = {"decode_attention": 0.0, "flash_attention": 0.0}

    def dec(self, label, q, k, v, pos, lens, window, tile=BS, timed=None):
        da = self.da
        got = da.decode_attention(q, k, v, pos, lens, window=window,
                                  tile=tile)
        want = da.decode_attention_plain(q, k, v, pos, lens, window)
        torch.cuda.synchronize()
        self.err["decode_attention"] = max(self.err["decode_attention"],
                                           check("decode_attention", label,
                                                 got, want, q.dtype))
        bf16_vs_fp32("decode_attention", label, got,
                     lambda *a: da.decode_attention_plain(*a, window),
                     q, k, v, pos, lens)
        if timed is not None:
            timed[label] = time_case(
                "decode_attention", label,
                lambda: da.decode_attention(q, k, v, pos, lens,
                                            window=window, tile=tile),
                lambda: da.decode_attention_plain(q, k, v, pos, lens,
                                                  window),
                lambda: sdpa_decode(q, k, v, pos, lens, window),
                dense_decode_bound(q, k, pos, lens, window), self.flush)
        return got

    def dec_identities(self, q, k, v, lens, windows):
        """The dense cache ``k``/``v`` (MAX_CONTEXT slots, pos = arange)
        laid into a block pool through a random table: the dense kernel
        at tile = BS bit for bit against ``paged_decode_attention`` on the
        pool, against itself on a DA_LONG_T-slot cache (empty past
        cache_len, as the round engine's wider rounds give) and across two
        launches, each row alone against its row in the batch.  Returns
        (pools, tables)."""
        da, pa = self.da, self.pa
        B_, K, T, D_ = k.shape
        device, dt = q.device, str(q.dtype)[6:]
        arange = torch.arange(T, dtype=torch.int32, device=device)
        tables = torch.randperm(B_ * BPR, device=device).reshape(
            B_, BPR).int()
        pools = []
        for c in (k, v):
            pool = torch.zeros(B_ * BPR + 1, BS, K, D_, dtype=q.dtype,
                               device=device)
            pool[tables.long().reshape(-1)] = c.transpose(1, 2).reshape(
                B_ * BPR, BS, K, D_)
            pools.append(pool)
        wide = [torch.cat([c.transpose(1, 2), torch.randn(
                    B_, DA_LONG_T - T, K, D_, dtype=q.dtype, device=device)],
                          1).transpose(1, 2) for c in (k, v)]
        wide_pos = torch.arange(DA_LONG_T, dtype=torch.int32, device=device)
        for window in windows:
            tag = f"{dt} H={q.shape[1]} K={K} D={D_} window={window}"
            got = da.decode_attention(q, k, v, arange, lens, window=window,
                                      tile=BS)
            identical("decode_attention", f"{tag} tile={BS}, pos=arange vs "
                      f"paged_decode_attention on the same K/V", got,
                      pa.paged_decode_attention(q, *pools, tables, lens,
                                                window=window))
            identical("decode_attention", f"{tag}, T={T} vs T={DA_LONG_T}",
                      got, da.decode_attention(q, *wide, wide_pos, lens,
                                               window=window, tile=BS))
            identical("decode_attention", f"{tag}, two launches", got,
                      da.decode_attention(q, k, v, arange, lens,
                                          window=window, tile=BS))
            for b in (0, 3, B_ - 1):
                one = da.decode_attention(q[b:b + 1], k[b:b + 1],
                                          v[b:b + 1], arange, lens[b:b + 1],
                                          window=window, tile=BS)
                identical("decode_attention", f"{tag}, row {b} alone vs in "
                          f"the batch of {B_}", one[0], got[b])
        return pools, tables

    def flash(self, label, B_, H_, K, S, T_, D_, causal, window, dtype,
              timed=None):
        fa = self.fa
        q, k, v = (torch.tensor(self.rng.standard_normal(shape), dtype=dtype,
                                device=self.device)
                   for shape in ((B_, H_, S, D_), (B_, K, T_, D_),
                                 (B_, K, T_, D_)))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        self.err["flash_attention"] = max(self.err["flash_attention"], check(
            "flash_attention", label, got, want, dtype))
        same = torch.equal(got, again)
        log(f"flash_attention {label} {str(dtype)[6:]}: reruns "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("flash_attention differs from itself")
        del want, again
        bf16_vs_fp32("flash_attention", label, got,
                     lambda *a: fa.flash_attention_plain(*a, causal, window),
                     q, k, v)
        if window > 0 and S >= T_ + window:
            # rows from T + window - 1 on have no valid key: mean of V
            first = T_ + window - 1
            mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
                H_ // K, dim=1)
            e = (got[:, :, first:].float() - mean).abs().max().item()
            log(f"flash_attention {label}: rows {first}.. (no valid key) "
                f"vs the mean of V: max abs err {e:.3e}")
            if not e <= TOL[dtype]:
                raise AssertionError("flash_attention: a row with no "
                                     "valid key is not the mean of V")
        if timed is not None:
            timed[label] = time_case(
                "flash_attention", label,
                lambda: fa.flash_attention(q, k, v, causal=causal,
                                           window=window),
                lambda: fa.flash_attention_plain(q, k, v, causal, window),
                lambda: sdpa_flash(q, k, v, causal, window),
                flash_bound(q, k, causal, window), self.flush)


def attention_phase(pa, da, fa, device):
    """Returns ({name: max abs err}, {name: timing at the main-path
    shape}) for decode_attention and flash_attention."""
    rng = np.random.default_rng(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = AttentionCases(pa, da, fa, rng, flush)
    dec, flash = cases.dec, cases.flash
    timing, extra = {}, {}

    T = MAX_CONTEXT
    arange = torch.arange(T, dtype=torch.int32, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, lens = dense_decode_case(rng, B, H, H, D, T, dtype, device)
        dec(f"B={B} H=K={H} D={D} T={T} ragged", q, k, v, arange, lens, 0)
        cases.dec_identities(q, k, v, lens, (0, 37))
        if dtype == torch.bfloat16:
            at100 = torch.full((B,), 100, dtype=torch.int32, device=device)
            dec("main path, every row at 100", q, k, v, arange, at100, 0,
                timed=timing)
            dec("main path, every row full", q, k, v, arange,
                torch.full((B,), T - 1, dtype=torch.int32, device=device),
                0, timed=extra)
    # GQA and a window at h2o-danube widths, T = 8192
    d = DANUBE
    q, k, v, lens = dense_decode_case(
        rng, B, d["H"], d["K"], d["D"], 8192, torch.bfloat16, device,
        lens=np.full(B, 8191, np.int32))
    dec(f"GQA {d['H']}/{d['K']} D={d['D']} T=8192 window={d['window']}",
        q, k, v, torch.arange(8192, dtype=torch.int32, device=device),
        lens, d["window"], timed=extra)
    # a ring cache: positions permuted, empty slots, scalar length
    q, k, v, _ = dense_decode_case(rng, B, H, H, D, T, torch.float32,
                                   device)
    ring = rng.permutation(np.arange(300 - T + 1, 301)).astype(np.int32)
    ring[:7] = -1
    dec(f"ring T={T} permuted pos, window 120", q, k, v,
        torch.tensor(ring, device=device), 300, 120)
    # a long context
    q, k, v, lens = dense_decode_case(
        rng, B, H, H, D, DA_LONG_T, torch.bfloat16, device,
        lens=np.full(B, DA_LONG_T - 1, np.int32))
    dec(f"long context T={DA_LONG_T} full", q, k, v,
        torch.arange(DA_LONG_T, dtype=torch.int32, device=device), lens, 0,
        timed=extra)

    for dtype in (torch.bfloat16, torch.float32):
        flash(f"B={FA_B} H=K={H} S=T={FA_S} D={D} causal", FA_B, H, H,
              FA_S, FA_S, D, True, 0, dtype,
              timed=timing if dtype == torch.bfloat16 else extra)
    flash(f"h2o-danube B=1 {d['H']}/{d['K']} S=T={FA_WINDOW_S} D={d['D']} "
          f"window={d['window']}", 1, d["H"], d["K"], FA_WINDOW_S,
          FA_WINDOW_S, d["D"], True, d["window"], torch.bfloat16,
          timed=extra)
    c = FA_CROSS
    flash(f"cross B={c['B']} S={c['S']} T={c['T']} causal=False", c["B"],
          H, H, c["S"], c["T"], D, False, 0, torch.bfloat16)
    flash(f"GQA {H}/{FA_OFF_TILE['K']} S=T={FA_OFF_TILE['S']} D={D} causal",
          1, H, FA_OFF_TILE["K"], FA_OFF_TILE["S"], FA_OFF_TILE["S"], D,
          True, 0, torch.bfloat16, timed=extra)
    e = FA_EMPTY
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            flash(f"S={e['S']} T={e['T']} window={e['window']} "
                  f"causal={causal}", 1, 4, 2, e["S"], e["T"], 16, causal,
                  e["window"], dtype)
    timing["decode_attention"] = timing.pop("main path, every row at 100")
    timing["flash_attention"] = timing.pop(
        f"B={FA_B} H=K={H} S=T={FA_S} D={D} causal")
    del flush
    torch.cuda.empty_cache()
    return cases.err, timing


# --------------------------------------------------------------------------
# phases 4-5: full-width serving
# --------------------------------------------------------------------------

def requests(vocab):
    """8 seeded requests, prompts 16-128 tokens; 0 and 7 share a 32-token
    prefix (7 is submitted once 0 has written it)."""
    from repro_torch.runtime.engine import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, 8)
    lens[0], lens[7] = max(lens[0], PREFIX + 16), max(lens[7], PREFIX + 16)
    prefix = rng.integers(0, vocab, PREFIX)
    out = []
    for i, n in enumerate(lens):
        p = rng.integers(0, vocab, int(n))
        if i in (0, 7):
            p[:PREFIX] = prefix
        out.append(Request(i, p.astype(np.int32), max_new_tokens=MAX_NEW))
    return out


def serve_full_width(api, params, megastep, sharing, paged=True,
                     faults=None):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine

    eng = ContinuousEngine(api, params, device=api.device,
                           config=EngineConfig(
                               hbm_budget=4 << 30, max_batch=B,
                               megastep=megastep, paged=paged,
                               prefix_sharing=sharing, block_size=BS,
                               max_context=MAX_CONTEXT), faults=faults)
    reqs = requests(api.cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs[:-1]:
        eng.submit(r)
    # the second sharer arrives once the first has written the prefix
    for _ in range(64):
        slot = [s for s in range(B) if eng.slots[s] is not None
                and eng.slots[s].req.id == 0]
        if slot and eng.slot_len[slot[0]] >= PREFIX:
            break
        eng.step()
    else:
        raise AssertionError("request 0 never wrote its prefix")
    eng.submit(reqs[-1])
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.assert_quiescent()
    if sorted(done) != list(range(8)) or not all(c.ok for c in done.values()):
        raise AssertionError(f"not every request completed: "
                             f"{ {k: c.status for k, c in done.items()} }")
    streams = {k: c.tokens for k, c in done.items()}
    for toks in streams.values():
        if len(toks) != MAX_NEW or not all(0 <= t < api.cfg.vocab_size
                                           for t in toks):
            raise AssertionError("malformed stream")
    return streams, eng, wall


# --------------------------------------------------------------------------
# phases 5b-5c: the dense-cache serving path and full-sequence prefill
# --------------------------------------------------------------------------

def serve_round(api, params):
    """The round engine on the same requests, all submitted up front; its
    cache is sized per round (max_context=None: the longest request,
    rounded up to 32 slots)."""
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ServingEngine

    eng = ServingEngine(api, params, device=api.device, config=EngineConfig(
        hbm_budget=4 << 30, max_batch=B, max_context=None, block_size=BS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in requests(api.cfg.vocab_size):
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(8)) or not all(c.ok for c in done.values()):
        raise AssertionError("round engine: not every request completed")
    return {k: c.tokens for k, c in done.items()}, eng, wall


def first_divergence(api, params, a, b, rid):
    """Logits of request ``rid`` at the first step where streams ``a`` and
    ``b`` part, recomputed by token-by-token dense decode of the prompt
    and the common prefix (B=1): the two tokens' logits and their gap."""
    from repro_torch.runtime.sampling import greedy_serving

    req = requests(api.cfg.vocab_size)[rid]
    step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    toks = list(req.prompt) + a[:step]
    caches = api.init_caches(1, len(toks) + 1, tile=BS)
    with torch.no_grad():
        for i, t in enumerate(toks):
            logits, caches = api.decode_fn(params, caches, {
                "tokens": torch.tensor([[t]], device=api.device),
                "cache_len": i})
    lg = logits[0].float()
    return (f"request {rid} step {step}: tokens {a[step]} / {b[step]}, "
            f"logits {lg[a[step]].item():.4f} / {lg[b[step]].item():.4f} "
            f"(gap {abs(lg[a[step]] - lg[b[step]]).item():.4f}); greedy "
            f"argmax here {int(greedy_serving(logits)[0])}")


def serve_phase(api, params, pa, da):
    """Phases 4-5b: the 8-request workload through ``ContinuousEngine``
    (paged, megastep 8, prefix sharing) at full width: one
    ``paged_append`` and one ``paged_decode_attention`` launch a layer
    and ``decode_fn`` call, no ``decode_attention``, a shared block; the
    same streams bit for bit at megastep 1 and with sharing off, then on
    the dense cache and through the round engine
    (:func:`dense_serve_phase`).  Returns the paged run's launches with
    the dense runs' ``decode_attention`` launches, and the paged run's
    ``decode_fn`` calls."""
    cfg = api.cfg
    calls = count_calls(api)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    da.reset_launches()
    streams, eng, wall = serve_full_width(api, params, 8, True)
    launched, n_calls = dict(pa.launches), calls[0]
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(t) for t in streams.values())
    log(f"serve: {cfg.name}: 8/8 requests, {n_tok} tokens in {wall:.3f} s "
        f"({n_tok / wall:.1f} tok/s), {eng.dispatches} dispatches "
        f"({eng.dispatches / n_tok:.4f} per token), {eng.megasteps} "
        f"megasteps, {calls[0]} decode_fn calls, shared block hits "
        f"{eng.kv.shared_block_hits}, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"serve: {cfg.name}: launches {launched}, decode_attention "
        f"{da.launches['decode_attention']}")
    for name, n in launched.items():
        if n != cfg.num_layers * calls[0]:
            raise AssertionError(f"{name}: {n} launches for {calls[0]} "
                                 f"decode_fn calls x {cfg.num_layers} "
                                 f"layers")
    if da.launches["decode_attention"]:
        raise AssertionError("the paged run launched decode_attention")
    if eng.kv.shared_block_hits == 0:
        raise AssertionError("prefix sharing never engaged")

    # phase 5: identity across megastep N and sharing
    for megastep, sharing in ((1, True), (8, False)):
        other, e2, w2 = serve_full_width(api, params, megastep, sharing)
        same = other == streams
        log(f"identity: {cfg.name} megastep {megastep}, sharing {sharing}: "
            f"streams {'bit-identical' if same else 'DIFFER'} ({w2:.3f} s, "
            f"{e2.dispatches} dispatches)")
        if not same:
            raise AssertionError("greedy streams differ")
    del eng, e2
    launched["decode_attention"] = dense_serve_phase(api, params, calls,
                                                     streams, pa, da)
    return launched, n_calls


def dense_serve_phase(api, params, calls, paged_streams, pa, da):
    """Phase 5b: the paged run's workload through ContinuousEngine(paged=
    False) at megastep 8 and 1 and through ServingEngine.  Each run
    zeroes the launch counts just before and reads them just after, and
    its streams must equal the paged run's (the first divergence is
    printed before the phase fails); returns the decode_attention
    launches of the three runs."""
    total = 0
    runs = (("continuous dense, megastep 8", 8),
            ("continuous dense, megastep 1", 1), ("round engine", None))
    streams_of = {}
    for label, megastep in runs:
        calls[0] = 0
        pa.reset_launches()
        da.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if megastep is None:
            streams, eng, wall = serve_round(api, params)
        else:
            streams, eng, wall = serve_full_width(api, params, megastep,
                                                  False, paged=False)
        launched = da.launches["decode_attention"]
        peak = torch.cuda.max_memory_allocated()
        n_tok = sum(len(t) for t in streams.values())
        log(f"dense: {label}: 8/8 requests, {n_tok} tokens in {wall:.3f} "
            f"s ({n_tok / wall:.1f} tok/s), {eng.dispatches} dispatches "
            f"({eng.dispatches / n_tok:.4f} per token), {calls[0]} "
            f"decode_fn calls, decode_attention launches {launched}, "
            f"paged launches {dict(pa.launches)}, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if launched != api.cfg.num_layers * calls[0] or calls[0] == 0:
            raise AssertionError(f"{label}: {launched} decode_attention "
                                 f"launches for {calls[0]} decode_fn calls")
        if any(pa.launches.values()):
            raise AssertionError(f"{label}: the paged kernels launched")
        total += launched
        streams_of[label] = streams
    for label, streams in streams_of.items():
        same = streams == paged_streams
        log(f"dense: {label}: streams "
            f"{'bit-identical to' if same else 'DIFFER from'} the paged run")
        if same:
            continue
        for rid in sorted(streams):
            if streams[rid] != paged_streams[rid]:
                log("dense:   first divergence: " + first_divergence(
                    api, params, streams[rid], paged_streams[rid], rid))
                break
        raise AssertionError(f"{label}: streams differ from the paged run")
    return total


def normwise(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def prefill_tokens(cfg, device):
    """The prefill phases' batch: PREFILL_B rows of PREFILL_S seeded
    tokens."""
    return {"tokens": torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)}


def kernel_modules():
    """The five kernel packages; each keeps its wrappers' launch
    counts."""
    from repro_torch.kernels import (branch_matmul, decode_attention,
                                     flash_attention, paged_attention,
                                     ssd_scan)

    return (paged_attention, branch_matmul, decode_attention,
            flash_attention, ssd_scan)


def prefill_phase(api, params, batch, name, patch, xcheck, device,
                  tol=PREFILL_TOL, readings=()):
    """Phase 5c (10 for mamba2, 29 for qwen2-vl): prefill_fn on ``batch``
    through the kernel ``name``, one launch a layer and no launch of
    another kernel, held to the same call with the
    plain version patched in (``patch``: module, attribute, function) —
    in the bf16 model at ``tol`` and in an fp32 model with the same
    weights at ``PREFILL_TOL_FP32`` — and to the token-by-token path on
    the first ``xcheck`` tokens of row 0 (a text prompt: where the model
    takes M-RoPE, every stream at the token's position).

    ``readings`` = ((label, patch, faulty), ...): variants patched in,
    each normwise from the plain version's logits inside ``tol`` where
    sound and outside it where ``faulty``, so the limit is shown to
    separate them.  Returns the launches of one prefill_fn call."""
    import importlib

    from repro_torch.models import build_model
    from repro_torch.runtime.sampling import greedy_serving
    from repro_torch.runtime.stepper import Stepper

    cfg = api.cfg
    mods = kernel_modules()

    def patched(api_, params_, swap):
        mod_name, attr, fn = swap
        mod = importlib.import_module(mod_name)
        saved = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            return api_.prefill_fn(params_, batch)
        finally:
            setattr(mod, attr, saved)

    Bn, n_text = batch["tokens"].shape
    n_front = batch["frontend_embeds"].shape[1] \
        if "frontend_embeds" in batch else 0
    shape = f"B={Bn} S={n_front + n_text}" + (
        f" ({n_front} frontend + {n_text} text)" if n_front else "")
    with torch.no_grad():
        api.prefill_fn(params, batch)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in mods:
            m.reset_launches()
        logits = api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        counts = kernel_counts(mods)
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(PREFILL_RUNS):
            t0 = time.perf_counter()
            api.prefill_fn(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        want = dict.fromkeys(counts, 0)
        want[name] = cfg.num_layers
        if logits.shape != (Bn, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError("prefill_fn: malformed logits")
        if counts != want:
            raise AssertionError(f"prefill_fn launches {counts}, expected "
                                 f"{want}")
        plain = patched(api, params, patch)
        far = [(label, faulty, normwise(patched(api, params, swap), plain))
               for label, swap, faulty in readings]
        torch.cuda.synchronize()
    rel = normwise(logits, plain)
    same_argmax = torch.equal(greedy_serving(logits), greedy_serving(plain))
    log(f"prefill: {cfg.name} prefill_fn {shape} at full width: "
        f"{counts[name]} {name} launches per call, "
        f"{float(np.median(walls)):.3f} ms per call (median of "
        f"{PREFILL_RUNS}, {min(walls):.3f}-{max(walls):.3f}), peak device "
        f"memory {peak / 2**30:.2f} GiB; vs the plain version: max abs "
        f"{(logits.float() - plain.float()).abs().max().item():.3e} on "
        f"|logits| <= {plain.float().abs().max().item():.2f}, normwise "
        f"{rel:.3e} (tol {tol:.3e}), argmax "
        f"{'equal' if same_argmax else 'DIFFERS'}")
    if readings:
        log("prefill: variants of the plain version, normwise from it"
            + "".join(f"; {label} {r:.3e}" for label, _, r in far))
    if not rel <= tol:
        raise AssertionError(f"prefill_fn off its plain-{name} version")
    for label, faulty, r in far:
        if (r <= tol) == faulty:
            raise AssertionError(f"prefill_fn: the limit {tol} does not "
                                 f"separate the variant {label} ({r:.3e})")
    # an fp32 model with the same weights: kernel against plain version
    # without bf16 rounding, and how far each bf16 path lies from it (the
    # kernel should add no more error than the plain version)
    api32 = build_model(cfg, device=device, dtype="float32")
    p32 = api32.init(None)
    p32.load_state_dict(params.state_dict())
    prompt = batch["tokens"][:1, :xcheck]
    text = {"tokens": prompt}
    if cfg.mrope_sections:
        text["positions3"] = torch.arange(
            xcheck, dtype=torch.int32, device=device).expand(3, 1, xcheck)
    with torch.no_grad():
        ref32 = api32.prefill_fn(p32, batch)
        plain32 = patched(api32, p32, patch)
        # the fp32 cross-check: prefill_fn against scalar token-by-token
        # decode on the dense cache, raw fp32 argmax (no bf16 ties)
        full32 = api32.prefill_fn(p32, text)
        caches = api32.init_caches(1, xcheck, tile=BS)
        for i in range(xcheck):
            step32, caches = api32.decode_fn(p32, caches, {
                "tokens": prompt[:, i:i + 1], "cache_len": i})
    torch.cuda.synchronize()
    rel32 = normwise(ref32, plain32)
    log(f"prefill: fp32 model, same weights: kernel vs plain version "
        f"normwise {rel32:.3e} (tol {PREFILL_TOL_FP32}); bf16 vs fp32 "
        f"evaluation: kernel path normwise {normwise(logits, ref32):.3e}, "
        f"plain path {normwise(plain, plain32):.3e}")
    if not rel32 <= PREFILL_TOL_FP32:
        raise AssertionError(f"fp32 prefill_fn off its plain-{name} "
                             f"version")
    a_full, a_step = int(full32[0].argmax()), int(step32[0].argmax())
    rel = normwise(full32, step32)
    diff = (full32 - step32).abs().max().item()
    gap = (full32[0, a_full] - full32[0, a_step]).abs().item()
    log(f"prefill: fp32 model, {xcheck}-token prompt: prefill_fn argmax "
        f"{a_full}, scalar token-by-token argmax {a_step}; logits normwise "
        f"{rel:.3e} (tol {PREFILL_TOL_FP32}), max abs {diff:.3e}")
    if not rel <= PREFILL_TOL_FP32 or (a_full != a_step and not gap <= diff):
        raise AssertionError("fp32 prefill_fn and the decode path disagree")
    del api32, p32, ref32, plain32, plain, full32, step32, caches
    torch.cuda.empty_cache()

    # the two serving paths on one xcheck-token prompt, in the bf16 model
    with torch.no_grad():
        full = api.prefill_fn(params, text)
        stepper = Stepper(api)
        caches = api.init_caches(1, xcheck, tile=BS)
        _, _, first, _ = stepper.prefill_chunk(
            params, caches, prompt.cpu().numpy(), np.zeros(1, np.int32),
            np.full(1, xcheck, np.int32))
        caches = api.init_caches(1, xcheck, tile=BS)
        for i in range(xcheck):                            # scalar path
            step, caches = api.decode_fn(params, caches, {
                "tokens": prompt[:, i:i + 1], "cache_len": i})
    a_full = int(greedy_serving(full)[0])
    a_step = int(first[0])
    gap = (full[0, a_full].float() - full[0, a_step].float()).abs().item()
    rel = normwise(full, step)
    log(f"prefill: {xcheck}-token prompt: prefill_fn argmax "
        f"{a_full}, Stepper.prefill_chunk first token {a_step} (dense "
        f"cache), scalar decode argmax {int(greedy_serving(step)[0])}; "
        f"prefill_fn vs token-by-token logits: normwise {rel:.3e} (tol "
        f"{XCHECK_TOL:.3e}), gap between the two argmaxes {gap:.4f}")
    if a_step != int(greedy_serving(step)[0]):
        raise AssertionError("vector and scalar dense decode disagree")
    if not rel <= XCHECK_TOL or (a_full != a_step and not gap <= (
            full.float() - step.float()).abs().max().item()):
        raise AssertionError("prefill_fn and the decode path disagree")
    return counts[name]


KERNEL_FAMILIES = (                # (substring of the kernel name, family)
    ("branch_matmul", "branch_matmul"),
    ("flash", "flash_attention"),
    ("paged_decode", "paged_decode_attention"),
    ("dense_decode", "decode_attention"),   # the splits merge inside it
    ("paged_append", "paged_append"),
    ("ssd_scan", "ssd_scan"),
)
HOST_OPS = 10                      # host rows of a step profile


def device_profile(label, fn, n, bound, wrappers=(), grad=False):
    """Where one call of ``fn`` spends its time: host+device wall time by
    the host clock, and the card's busy time by ``torch.profiler`` (the
    sum of its kernels, which run in order on one stream), split by
    kernel family.  ``bound`` = (ms, what) bounds the call from below.
    ``wrappers``: (family, launches dict) pairs; the dict's count under
    the family's name (its wrapper calls in the profiled window) is set
    beside the family's device kernels.  Then the host side: the
    operators and CUDA runtime calls with the most self time a call
    (under the profiler, which adds its own cost to each).  ``grad``:
    run ``fn`` with gradients on (a train step), else under
    ``torch.no_grad()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        before = {fam: d[fam] for fam, d in wrappers}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    by_family: "dict[str, float]" = {}
    count: "dict[str, int]" = {}
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        family = next((fam for key, fam in KERNEL_FAMILIES if key in name),
                      None)
        if family is None:
            family = ("matmul" if any(k in name for k in (
                "gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk"))
                else "other (elementwise, norms, rope, conv, sampling)")
        by_family[family] = (by_family.get(family, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / n)
        count[family] = count.get(family, 0) + 1
        launches += 1
    for fam, d in wrappers:
        calls = d[fam] - before[fam]
        kernels = count.get(fam, 0)
        if calls:
            log(f"step: {label}: {fam}: {kernels} device kernels for "
                f"{calls} wrapper calls ({kernels / calls:.2f} a call)")
    busy = sum(by_family.values())
    if busy == 0.0:
        log(f"step: {label}: wall {wall:.3f} ms; device time not measured "
            f"(the profiler saw no kernels); {bound[1]} bound "
            f"{bound[0]:.3f} ms")
        return
    log(f"step: {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({launches / n:.0f} kernels a call), idle share {1 - busy / wall:.3f}, "
        f"{bound[1]} bound {bound[0]:.3f} ms")
    for family, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"step:   {family}: {ms:.3f} ms ({ms / busy:.1%} of busy)")
    ops = [a for a in prof.key_averages()
           if a.device_type == DeviceType.CPU]
    total = sum(a.self_cpu_time_total for a in ops) / n / 1e3
    log(f"step: {label}: host self time in operators and runtime calls "
        f"{total:.3f} ms a call under the profiler")
    for a in sorted(ops, key=lambda a: -a.self_cpu_time_total)[:HOST_OPS]:
        log(f"step:   host {a.key}: {a.self_cpu_time_total / n / 1e3:.3f} "
            f"ms self, {a.count / n:.0f} a call")
    log(f"step: {label}: runtime calls a call: " + ", ".join(
        f"{a.key} {a.count / n:g}" for a in ops if a.key.startswith("cu")))


def routed_weight_bytes(params, fn):
    """The weight bytes one call of ``fn`` must read when each MoE layer
    reads only the experts its tokens were routed to (the kernel skips
    the others): every other weight, plus each layer's routed experts'
    gate, up and down matrices."""
    moes = [layer.moe for layer in params.layers if layer.kind[1] == "moe"]
    total = sum(p.numel() * p.element_size() for p in params.parameters())
    experts = sum(p.numel() * p.element_size() for m in moes
                  for p in (m.w_gate, m.w_up, m.w_down))
    with torch.no_grad(), RoutingRecorder() as rec:
        fn()
    per_expert = experts // (len(moes) * moes[0].w_gate.shape[0])
    routed = sum(ids.unique().numel() for ids, _ in rec.calls)
    return total - experts + routed * per_expert


def step_profile(api, params, device, wrappers=()):
    """One full-width ``decode_fn`` call (B=8 distinct seeded tokens,
    every row at position 100) through :func:`device_profile`, on the
    paged pool and, for a model that attends, on the dense cache
    (MAX_CONTEXT slots a row); the weight bytes the call must read (in a
    MoE model, the routed experts' only) over the memory rate bound the
    step from below."""
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, api.cfg.vocab_size, (B, 1)), dtype=torch.int32, device=device)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    bound = (weight_bytes / HBM_BYTES_PER_S * 1e3, "weight-read")
    if api.cfg.num_heads:
        dense = api.init_caches(B, MAX_CONTEXT, tile=BS)
        at100 = {"tokens": tokens,
                 "cache_len": torch.full((B,), 100, dtype=torch.int32,
                                         device=device)}
        device_profile(f"full-width {api.cfg.name} dense decode_fn (B=8, "
                       f"position 100, {MAX_CONTEXT} slots)",
                       lambda: api.decode_fn(params, dense, at100), 5,
                       bound, wrappers)
        del dense
    caches = api.init_paged_caches(B, B * BPR, BS)
    batch = {"tokens": tokens,
             "cache_len": torch.full((B,), 100, dtype=torch.int32,
                                     device=device),
             "active": torch.ones(B, dtype=torch.bool, device=device),
             "block_tables": torch.arange(B * BPR, dtype=torch.int32,
                                          device=device).reshape(B, BPR)}
    if api.cfg.moe is not None and any(
            layer.kind[1] == "moe" for layer in params.layers):
        routed = routed_weight_bytes(
            params, lambda: api.decode_fn(params, caches, batch))
        bound = (routed / HBM_BYTES_PER_S * 1e3,
                 "weight-read (routed experts)")
    device_profile(f"full-width {api.cfg.name} decode_fn (B=8, position "
                   f"100)", lambda: api.decode_fn(params, caches, batch), 5,
                   bound, wrappers)


def reference_phase(device):
    """Reduced fp32 model: the card (kernels) against the CPU (plain
    versions) on the same weights and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("stablelm-3b").reduced()
    gpu = build_model(cfg, device=device)
    cpu = build_model(cfg, device="cpu")
    p_gpu = gpu.init(torch.Generator(device=device).manual_seed(1))
    p_cpu = cpu.init(None)
    p_cpu.load_state_dict(p_gpu.state_dict())
    rng = np.random.default_rng(1)
    b, bs, bpr = 4, 16, 4
    tables = rng.permutation(b * bpr).reshape(b, bpr).astype(np.int32)
    c_gpu = gpu.init_paged_caches(b, b * bpr, bs)
    c_cpu = cpu.init_paged_caches(b, b * bpr, bs)
    lens = np.zeros(b, np.int32)
    worst = 0.0
    for step in range(12):
        active = np.array([True, True, step % 3 != 0, step < 6])
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)),
                 "cache_len": lens, "active": active, "block_tables": tables}
        lg, c_gpu = gpu.decode_fn(p_gpu, c_gpu, {
            k: torch.tensor(v, device=device) for k, v in batch.items()})
        lc, c_cpu = cpu.decode_fn(p_cpu, c_cpu, {
            k: torch.tensor(v) for k, v in batch.items()})
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-5, atol=2e-5)
        lens = lens + active
    log(f"reference: reduced fp32 decode logits, card vs CPU over 12 "
        f"steps: max abs err {worst:.3e} (tol 2e-5)")


# --------------------------------------------------------------------------
# phase 3b: branch_matmul against its plain version and torch.bmm
# --------------------------------------------------------------------------

def gemm_bound(G, M, K, N, dtype):
    """Least time for (G, M, K) x (G, K, N): the larger of its operations
    over the card's peak for the type and its bytes (each operand read
    once, the output written once) over the memory rate."""
    item = torch.finfo(dtype).bits // 8
    t_ops = 2 * G * M * K * N / PEAK_FLOPS[dtype] * 1e3
    t_bytes = (G * M * K + G * K * N + G * M * N) * item / HBM_BYTES_PER_S \
        * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gemm_routed_bound(M, K, N, dtype, counts):
    """Least time for the same product with per-group row counts (the
    work this run's data needs): the operations of the routed rows
    (counts clamped to [0, M]); the bytes of those rows, of the weights
    of the groups with a row, and of the whole output (the rows past the
    counts are written, as zeros)."""
    item = torch.finfo(dtype).bits // 8
    rows = counts.clamp(0, M)
    routed, live = int(rows.sum()), int((rows > 0).sum())
    t_ops = 2 * routed * K * N / PEAK_FLOPS[dtype] * 1e3
    t_bytes = (routed * K + live * K * N + counts.numel() * M * N) * item \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bf16_tile_rows(M):
    """Rows of the bf16 block tile the kernel picks for capacity M (as
    ``tc::dispatch`` in csrc/branch_matmul.cu)."""
    return 16 if M <= 16 else 64 if M < 512 else 128


def bits(t):
    """The raw bits of a float tensor (so -0 differs from 0)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def grouped_mm_call(x, w, counts, got):
    """A ``torch._grouped_mm`` call on the routed rows of (x, counts),
    packed group after group, with w as it lies or as a column-major copy
    (whichever this torch takes), held against the kernel's routed rows
    ``got`` at the bf16 tolerance: (call, note), call None where this
    torch has no ``_grouped_mm`` or takes neither layout.  A yardstick
    only: the port never calls it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm absent"
    if x.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16"
    live = torch.arange(x.shape[1], device=x.device)[None, :] \
        < counts.clamp(0, x.shape[1])[:, None]
    a = x[live]
    offs = torch.cumsum(counts.clamp(0, x.shape[1]), 0, dtype=torch.int32)
    notes = []
    for layout in ("row-major", "column-major"):
        b = w if layout == "row-major" \
            else w.transpose(1, 2).contiguous().transpose(1, 2)
        try:
            out = fn(a, b, offs=offs)
            torch.cuda.synchronize()
        except Exception as exc:               # noqa: BLE001 - yardstick
            notes.append(f"{layout} w refused: {str(exc)[:160]}")
            del b
            continue
        e = (out.float() - got[live].float()).abs().max().item() \
            if out.numel() else 0.0
        if not e <= TOL[x.dtype]:
            raise AssertionError(f"torch._grouped_mm off the kernel by {e}")
        del out
        return (lambda: fn(a, b, offs=offs)), f"{layout} w, max abs " \
            f"{e:.3e} from the kernel's routed rows"
    return None, "; ".join(notes)


def bf16_ulp(t):
    """One bf16 ulp at each |t| (bf16 keeps 8 significant bits)."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def gemm_close(got, want):
    """(max abs err, whether every element is close): within the dtype's
    tolerance or, in bf16, one ulp of the larger magnitude, whichever is
    more.  Two correctly rounded fp32 sums of one product in different
    orders land on the same or adjacent bf16 values, and from |y| = 4 up
    an ulp exceeds the 2e-2 tolerance (the random-operand cases keep
    their outputs below 4; a model's activations do not).  A few groups
    at a time, so the fp32 copies stay small beside a full-width model."""
    err, close = 0.0, True
    for g0 in range(0, got.shape[0], 8):
        a, b = got[g0:g0 + 8].float(), want[g0:g0 + 8].float()
        diff = (a - b).abs()
        allowed = torch.full_like(diff, TOL[got.dtype])
        if got.dtype == torch.bfloat16:
            allowed = torch.maximum(allowed, bf16_ulp(
                torch.maximum(a.abs(), b.abs())))
        err = max(err, diff.max().item() if diff.numel() else 0.0)
        close = close and bool((diff <= allowed).all())
    return err, close


def counts_hold(got, full, counts):
    """(rows below each group's count bit-identical to ``full``, rows past
    it exact zeros), group by group."""
    below, zeros = True, True
    for g, c in enumerate(counts.clamp(0, got.shape[1]).tolist()):
        below = below and torch.equal(bits(got[g, :c]), bits(full[g, :c]))
        zeros = zeros and not bits(got[g, c:]).any().item()
    return below, zeros


def gemm_case(bm, label, x, w, flush, iters=50, extra=None, counts=None):
    """``branch_matmul`` on (x, w), with per-group row ``counts`` if given,
    against its plain version (same counts) at the dtype's tolerance (or
    one bf16 ulp, :func:`gemm_close`) and
    bit for bit against a second launch and, with ``extra`` rows (G, m,
    K), against the same rows at capacity M + m.  With counts, also: the
    rows below each count bit-identical to the launch without counts, the
    rows past it exact zeros; and a ``torch._grouped_mm`` call on the
    routed rows, where this torch has one.  Timed beside its plain
    version, one ``torch.bmm`` call on all M rows, its bound and, with
    counts, the routed-work bound.  Returns dict(err, ms, plain_ms,
    library_ms, grouped_ms, bound, bound_by, routed, routed_by)."""
    G, M, K = x.shape
    N = w.shape[2]
    dtype = x.dtype
    got = bm.branch_matmul(x, w, counts)
    same = torch.equal(got, bm.branch_matmul(x, w, counts))
    e, close = gemm_close(got, bm.branch_matmul_plain(x, w, counts))
    ok = close and same
    notes = ""
    grouped = None
    if counts is None:
        as_bmm = torch.equal(got, torch.bmm(x, w))
        notes += (f", {'bit-identical to' if as_bmm else 'differs from'} "
                  f"torch.bmm")
    else:
        full = bm.branch_matmul(x, w)
        below, zeros = counts_hold(got, full, counts)
        ok = ok and below and zeros
        rows = counts.clamp(0, M)
        tiles = bf16_tile_rows(M) if dtype == torch.bfloat16 else None
        computed = int((-(-rows // tiles) * tiles).sum()) if tiles else None
        notes += (f", counts {int(rows.min())}-{int(rows.max())} "
                  f"({int(rows.sum())} routed rows of {G * M}, "
                  f"{int((rows > 0).sum())} of {G} groups with a row"
                  f"{f', {computed} rows computed in tiles of {tiles}' if tiles else ''}"
                  f"): rows below the counts "
                  f"{'bit-identical to' if below else 'DIFFER from'} the "
                  f"launch without counts, rows past them "
                  f"{'exact zeros' if zeros else 'NOT ZERO'}")
        del full
        grouped, note = grouped_mm_call(x, w, counts, got)
        notes += f"; {note}"
    if extra is not None:
        wider = bm.branch_matmul(torch.cat([x, extra], 1), w, counts)[:, :M]
        same_cap = torch.equal(got, wider)
        ok = ok and same_cap
        notes += (f", rows at capacity {M + extra.shape[1]} "
                  f"{'bit-identical' if same_cap else 'DIFFER'}")
        del wider
    del got
    ms = median_ms(lambda: bm.branch_matmul(x, w, counts), flush, iters)
    plain_ms = median_ms(lambda: bm.branch_matmul_plain(x, w, counts), flush,
                         iters)
    lib_ms = median_ms(lambda: torch.bmm(x, w), flush, iters)
    grouped_ms = None if grouped is None \
        else median_ms(grouped, flush, iters)
    bound, bound_by = gemm_bound(G, M, K, N, dtype)
    routed, routed_by = (bound, bound_by) if counts is None \
        else gemm_routed_bound(M, K, N, dtype, counts)
    log(f"branch_matmul {label} {str(dtype)[6:]} G={G} M={M} K={K} N={N}: "
        f"max abs err {e:.3e} ({'within' if close else 'NOT within'} "
        f"{TOL[dtype]}{' or one bf16 ulp' if dtype == torch.bfloat16 else ''}"
        f"), reruns "
        f"{'bit-identical' if same else 'DIFFER'}{notes}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
        f"{lib_ms:.4f} ms"
        f"{'' if grouped_ms is None else f', torch._grouped_mm {grouped_ms:.4f} ms'}"
        f", bound {bound:.5f} ms ({bound_by})"
        f"{'' if counts is None else f', routed-work bound {routed:.5f} ms ({routed_by})'}"
        f", {2 * G * M * K * N / ms / 1e9:.1f} TFLOP/s of padded rows")
    if not ok:
        raise AssertionError(f"branch_matmul {label}: off its plain version,"
                             f" a rerun, another capacity or its counts")
    return dict(err=e, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                grouped_ms=grouped_ms, bound=bound, bound_by=bound_by,
                routed=routed, routed_by=routed_by)


def add_timing(total, case, n=1):
    """Add ``n`` times a gemm_case's times and bounds to ``total``
    (``grouped_ms`` only while every case has one)."""
    for key in ("ms", "plain_ms", "library_ms", "bound", "routed"):
        total[key] = total.get(key, 0.0) + n * case[key]
    g = case["grouped_ms"]
    total["grouped_ms"] = None if g is None or total.get(
        "grouped_ms", 0.0) is None else total.get("grouped_ms", 0.0) + n * g
    total.setdefault("by", set()).add(case["bound_by"])
    total.setdefault("routed_by", set()).add(case["routed_by"])


def branch_phase(bm, device):
    """Both planner sites in fp32 and bf16, and a ragged group; returns
    (max abs err, timing summed over the two fp32 sites of one fused
    run)."""
    rng = np.random.default_rng(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst = 0.0
    total = {}
    for site, (G, M, K, N) in BM_SITES.items():
        # outputs of std 0.5 stay below 4, where a bf16 ulp (1.6e-2) is
        # under the tolerance: two fp32 sums may round to adjacent values
        x0 = rng.standard_normal((G, M, K), dtype=np.float32)
        w0 = rng.standard_normal((G, K, N), dtype=np.float32) \
            / np.float32(2 * np.sqrt(K))
        counts = torch.tensor(BM_COUNTS, dtype=torch.int32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(x0, device=device).to(dtype)
            w = torch.tensor(w0, device=device).to(dtype)
            case = gemm_case(bm, site, x, w, flush)
            worst = max(worst, case["err"])
            if dtype == torch.float32:
                add_timing(total, case)
            case = gemm_case(bm, f"{site} with counts {BM_COUNTS}", x, w,
                             flush, 10, counts=counts)
            worst = max(worst, case["err"])
    from repro_torch.kernels.branch_matmul import parallel_branches
    xs = [torch.tensor(rng.standard_normal((m, 80), dtype=np.float32),
                       device=device) for m in (512, 384, 450, 129)]
    ws = [torch.tensor(rng.standard_normal((80, 2560), dtype=np.float32)
                       / np.float32(np.sqrt(80)), device=device) for _ in xs]
    for o, x, w in zip(parallel_branches(xs, ws), xs, ws):
        e = (o - bm.branch_matmul_plain(x[None], w[None])[0]).abs().max()
        worst = max(worst, e.item())
        if not e.item() <= TOL[torch.float32]:
            raise AssertionError("parallel_branches disagrees on a ragged "
                                 "group")
    log(f"branch_matmul ragged parallel_branches M=(512, 384, 450, 129) "
        f"K=80 N=2560 fp32: max abs err {worst:.3e}")
    total["bound"] = (total["bound"], "/".join(sorted(total.pop("by"))))
    total.pop("routed_by")
    log(f"branch_matmul per fused run (qkv + out sites, fp32): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"torch.bmm {total['library_ms']:.4f} ms, bound "
        f"{total['bound'][0]:.5f} ms ({total['bound'][1]})")
    return worst, total


# --------------------------------------------------------------------------
# phases 8-9: the §3 planner and PlanExecutor
# --------------------------------------------------------------------------

def run_modes(plan, env, device, modes, runs, bm=None):
    """Every mode runs once (its output, and the peak device memory it
    allocates above what was resident), then ``runs`` timed runs with the
    modes taking turns, so drift on the shared host spreads over all of
    them; each run ends in its own sync.  Returns {mode: (output,
    dispatches, syncs, (median, min, max) ms, peak GiB)}.  With ``bm``,
    every run must launch ``branch_matmul`` once per GEMM site of its
    compiled schedule (0 for the other modes)."""
    from repro_torch.core import PlanExecutor

    exs = {mode: PlanExecutor(plan, device=device, **kw)
           for mode, kw in modes.items()}

    def run(mode):
        ex = exs[mode]
        sites = (ex.compiled.stats.gemm_sites if ex.compiled is not None
                 and ex.compiled.use_branch_kernel else 0)
        before = bm.launches["branch_matmul"] if bm else 0
        t0 = time.perf_counter()
        res = ex(env)
        ms = (time.perf_counter() - t0) * 1e3
        if bm and bm.launches["branch_matmul"] - before != sites:
            raise AssertionError(f"{mode}: {bm.launches} launches, "
                                 f"expected {sites} per run")
        if modes[mode].get("mode") != "sequential" \
                and ex.last_sync_count != 1:
            raise AssertionError(f"{mode}: {ex.last_sync_count} syncs")
        return res.outputs[plan.graph.outputs[0]], ms

    outs, peaks = {}, {}
    for mode in exs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        outs[mode] = run(mode)[0]
        peaks[mode] = (torch.cuda.max_memory_allocated() - resident) / 2**30
    walls = {mode: [] for mode in exs}
    for _ in range(runs):
        for mode in exs:
            walls[mode].append(run(mode)[1])
    return {mode: (outs[mode], ex.last_dispatch_count, ex.last_sync_count,
                   (float(np.median(walls[mode])), min(walls[mode]),
                    max(walls[mode])), peaks[mode])
            for mode, ex in exs.items()}


def fused_with_plain_gemm(plan, env, device, bm):
    """The fused schedule's output with ``branch_matmul_plain`` (cuBLAS
    ``bmm``) in place of the kernel: the same GEMMs in another summation
    order, so it isolates the kernel from this graph's conditioning."""
    import importlib

    from repro_torch.core import PlanExecutor

    ops = importlib.import_module("repro_torch.kernels.branch_matmul.ops")
    kernel = ops.branch_matmul
    ops.branch_matmul = bm.branch_matmul_plain
    try:
        res = PlanExecutor(plan, device=device)(env)
    finally:
        ops.branch_matmul = kernel
    return res.outputs[plan.graph.outputs[0]]


def planner_kernel_path(bm, device):
    """Phase 8: returns the ``branch_matmul`` launches of the main path."""
    import torch_graph_zoo as tz
    from repro_torch.core import (ArenaExecutor, ParallaxConfig,
                                  compile_plan, compile_schedule)
    from repro_torch.core.executor import to_device

    g, make = tz.multihead_graph(**PLANNER_GRAPH)
    budget = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    plan = compile_plan(g, ParallaxConfig(budget=budget))
    plan_s = time.perf_counter() - t0
    stats = compile_schedule(plan, donate=True).stats
    log(f"planner A: multihead_graph{tuple(PLANNER_GRAPH.values())} fp32, "
        f"{g.num_nodes()} nodes, budget {budget / 2**30:.2f} GiB free on "
        f"the card: planned in {plan_s:.3f} s, {stats}")
    if stats.batched_groups < 1 or stats.gemm_sites != 2:
        raise AssertionError("the planner path does not reach "
                             "branch_matmul at full width")
    env = to_device(make(np.random.default_rng(0)), device)
    torch.cuda.synchronize()
    bm.reset_launches()
    res = run_modes(plan, env, device, MODES, RUNS_A, bm)
    launches = bm.launches["branch_matmul"]
    ref = res["reference"][0]
    exact = g.execute({t: v.double() for t, v in env.items()})[g.outputs[0]]
    plain = fused_with_plain_gemm(plan, env, device, bm)
    for mode, (o, disp, syncs, ms, peak) in res.items():
        rel = ((o - ref).norm() / ref.norm()).item()
        rel64 = ((o.double() - exact).norm() / exact.norm()).item()
        log(f"planner A: {mode:18s} {disp:4d} dispatches, {syncs} syncs, "
            f"{ms[0]:7.3f} ms/run ({ms[1]:.3f}-{ms[2]:.3f}), peak "
            f"+{peak:.3f} GiB; vs reference: max abs "
            f"{(o - ref).abs().max().item():.3e}, normwise {rel:.3e}; vs "
            f"float64: max abs {(o.double() - exact).abs().max().item():.3e}"
            f", normwise {rel64:.3e}")
        if mode in ("fused", "whole_plan"):      # through branch_matmul
            if not (torch.allclose(o, plain, rtol=2e-5, atol=2e-5)
                    and rel <= 1e-4):
                raise AssertionError(f"{mode}: kernel path off its plain "
                                     f"version or {rel:.3e} from reference")
        elif not torch.equal(o, ref):
            raise AssertionError(f"{mode} differs from reference")
    log(f"planner A: fused with the plain GEMM vs with the kernel: max abs "
        f"{(plain - res['fused'][0]).abs().max().item():.3e} (rtol=atol="
        f"2e-5 holds); output max |y| {ref.abs().max().item():.1f}")
    arena = ArenaExecutor(plan, device=device)(env)[g.outputs[0]]
    if not torch.equal(arena, ref):
        raise AssertionError("ArenaExecutor differs from reference")
    log(f"planner A: ArenaExecutor bit-identical to reference; "
        f"branch_matmul launches on this path: {launches} "
        f"({stats.gemm_sites} per fused or whole-plan run)")
    return launches


def dag_check(label, cfg, lm, seq, modes, runs, device, tol=None,
              unsupported=None, scan=None, arena=False):
    """``export_graph`` of ``lm`` (the decoder graph, or Whisper's encoder
    graph) at batch ``DAG_BATCH`` and ``seq``, planned with the card's free memory as the §3.3 budget and
    run in every mode of ``modes`` (``runs`` timed runs each), every run
    launching ``branch_matmul`` once per GEMM site of its schedule.  Each
    mode's logits within ``tol`` of the op-by-op oracle or, with
    ``tol=None``, bit-identical to ``reference``.  ``unsupported``: the
    name suffix of the one unsupported node a layer; ``scan``: the
    ``ssd_scan`` wrapper module, launched once a layer by the oracle and
    by every run; ``arena``: the ArenaExecutor equals reference too.
    Returns the schedule's CompileStats."""
    from repro_torch.core import (ArenaExecutor, ParallaxConfig,
                                  clear_compile_cache, compile_plan,
                                  compile_schedule)
    from repro_torch.core.executor import to_device
    from repro_torch.kernels import branch_matmul as bm
    from repro_torch.models.dag_export import export_graph

    t0 = time.perf_counter()
    g, make = export_graph(cfg, lm, DAG_BATCH, seq)
    export_s = time.perf_counter() - t0
    n_layers, width = dag_layers(cfg)
    marked = ""
    if unsupported:
        nodes = [n for n in g.nodes.values() if n.name.endswith(unsupported)]
        if len(nodes) != cfg.num_layers or any(n.supported for n in nodes):
            raise AssertionError(f"the DAG lacks its unsupported "
                                 f"{unsupported} nodes")
        marked = f" ({len(nodes)} unsupported {unsupported} nodes)"
    budget = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    plan = compile_plan(g, ParallaxConfig(budget=budget))
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = compile_schedule(plan, donate=True).stats
    lower_s = time.perf_counter() - t0
    widths = collections.Counter(sl.width() for sl in plan.schedule.layers)
    log(f"{label}: {cfg.name} full width, {n_layers} layers (fp32), "
        f"batch {DAG_BATCH}, seq {seq}: {g.num_nodes()} nodes{marked}, "
        f"built+exported in {export_s:.1f} s; planned in {plan_s:.2f} s "
        f"(budget {budget / 2**30:.2f} GiB) into {len(plan.branches)} "
        f"branches ({len(plan.branches) / n_layers:.1f} a model "
        f"layer), {len(plan.layers)} layers, {len(plan.schedule.layers)} "
        f"scheduled layers (width: count {dict(sorted(widths.items()))}, "
        f"max {plan.schedule.max_width()}); lowered in {lower_s:.2f} s, "
        f"{stats}")
    env = to_device(make(np.random.default_rng(0)), device)
    if scan:
        scan.reset_launches()
    oracle = g.execute(env)[g.outputs[0]]
    torch.cuda.synchronize()
    if scan and scan.launches["ssd_scan"] != cfg.num_layers:
        raise AssertionError("the oracle did not run ssd_scan per layer")
    if oracle.shape != (DAG_BATCH, seq, width) \
            or not torch.isfinite(oracle).all():
        raise AssertionError("malformed logits")
    if scan:
        scan.reset_launches()
    res = run_modes(plan, env, device, modes, runs, bm)
    if scan:
        n = len(modes) * (1 + runs)
        launched = scan.launches["ssd_scan"]
        log(f"{label}: {launched} ssd_scan launches in {n} runs "
            f"({launched / n:.0f} per run)")
        if launched != cfg.num_layers * n:
            raise AssertionError("not one ssd_scan launch per layer per run")
    ref = res["reference"][0]
    against = "reference" if tol is None else "the oracle"
    for mode, (o, disp, syncs, ms, peak) in res.items():
        same = torch.equal(o, ref if tol is None else oracle)
        log(f"{label}: {mode:12s} {disp:5d} dispatches, {syncs:3d} syncs, "
            f"{ms[0]:9.3f} ms/run ({ms[1]:.3f}-{ms[2]:.3f}), peak "
            f"+{peak:.2f} GiB; vs the oracle: max abs "
            f"{(o - oracle).abs().max().item():.3e}; "
            f"{'bit-identical to' if same else 'not bit-identical to'} "
            f"{against}")
        if not (same if tol is None
                else torch.allclose(o, oracle, rtol=tol, atol=tol)):
            raise AssertionError(f"{label}: {mode} off {against}")
    if arena:
        same = torch.equal(ArenaExecutor(plan, device=device)(env)[
            g.outputs[0]], ref)
        log(f"{label}: ArenaExecutor logits "
            f"{'bit-identical to' if same else 'DIFFER from'} reference; "
            f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if not same:
            raise AssertionError("ArenaExecutor differs from reference")
    del g, make, plan, env, res, ref, oracle
    clear_compile_cache()
    return stats


def dag_layers(cfg):
    """(model layers, output width) of ``export_graph``'s DAG: the
    encoder's layers and d_model for an encoder-decoder, else the
    decoder's layers and the vocabulary."""
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers, cfg.d_model
    return cfg.num_layers, cfg.vocab_size


def planner_model_dag(device):
    """Phase 9: stablelm-3b at full width, ``DAG_LAYERS`` deep, through
    the planner; then hetero C on the same model."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("stablelm-3b"),
                              num_layers=DAG_LAYERS)
    lm = build_model(cfg, device=device, dtype="float32").init(
        torch.Generator(device=device).manual_seed(0))
    modes = {k: v for k, v in MODES.items() if k != "fused, kernel off"}
    dag_check("planner B", cfg, lm, DAG_SEQ, modes, RUNS_B, device,
              arena=True)
    hetero_dag("hetero C", cfg, lm, DAG_SEQ, device,
               ("MOBILE_CONFIG", "H100_CONFIG"),
               normwise_close(HETERO_NORMWISE, argmax=True))
    del lm
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 20: the heterogeneous runtime (host CPU beside the card)
# --------------------------------------------------------------------------

def h100_profile_phase(device):
    """The two constants of ``core.partition.H100`` that no data sheet
    gives: the dispatch latency L (median host time of one tiny kernel
    launch plus a 4-byte card -> host copy, which waits for it) and the
    host's fallback rate R_cpu (one fp32 1024^3 matmul on the CPU)."""
    from repro_torch.core import H100

    x = torch.zeros(1, device=device)
    lat = []
    for i in range(HETERO_LAT_ITERS + 20):
        t0 = time.perf_counter()
        (x + 1).to("cpu")
        if i >= 20:                                  # 20 warm-up rounds
            lat.append(time.perf_counter() - t0)
    n = HETERO_CPU_MM
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, generator=gen)
    b = torch.randn(n, n, generator=gen)
    mm = []
    for i in range(7):
        t0 = time.perf_counter()
        a @ b
        if i >= 2:
            mm.append(time.perf_counter() - t0)
    L, t_mm = float(np.median(lat)), float(np.median(mm))
    log(f"h100 profile: L = {L * 1e6:.2f} us (median of {len(lat)}: "
        f"launch + 4-byte copy to the host; {min(lat) * 1e6:.2f}-"
        f"{max(lat) * 1e6:.2f}), R_cpu = {n ** 3 / t_mm:.4e} MAC/s (fp32 "
        f"{n}^3 matmul, {t_mm * 1e3:.3f} ms median of {len(mm)}, "
        f"{torch.get_num_threads()} CPU threads); floor L*R_cpu = "
        f"{L * n ** 3 / t_mm:.4e}; the profile in use: {H100}, floor "
        f"{H100.derived_flops_floor():.4e}")


def host_env(env):
    """Graph inputs as host numpy arrays (caller-owned host memory, the
    transfer plan's EXTERNAL source)."""
    return {t: v.cpu().numpy() if torch.is_tensor(v) else v
            for t, v in env.items()}


def hetero_runs(label, plan, env, device, runs, profile=None,
                wrappers=()):
    """``runs`` runs of ``parallax-hetero`` over ``plan`` (placed under
    ``profile``, or the plan's own).  Every run: one sync, transfer bytes
    equal to the plan's ``physical_bytes()``, dispatches per device
    summing to the run's dispatches, each of ``wrappers`` ((kernel
    module, name, launches a run), counts set to 0 just before the runs
    and read just after) launched as stated, and outputs bit-identical
    to the first run.  Returns (executor, output, wall ms per run)."""
    from repro_torch.core import PlanExecutor

    ex = PlanExecutor(plan, "parallax-hetero", device=device,
                      hetero_profile=profile)
    tp = ex.plan.attrs["transfers"]
    first, walls = None, []
    for mod, _, _ in wrappers:
        mod.reset_launches()
    for i in range(runs):
        t0 = time.perf_counter()
        out = ex(env).outputs[plan.graph.outputs[0]]   # ends in its sync
        walls.append((time.perf_counter() - t0) * 1e3)
        for mod, name, want in wrappers:
            if mod.launches[name] != want * (i + 1):
                raise AssertionError(f"{label}: {mod.launches[name]} {name}"
                                     f" launches in {i + 1} runs, expected "
                                     f"{want} a run")
        if (ex.last_sync_count != 1
                or ex.last_transfer_bytes != tp.physical_bytes()
                or sum(ex.last_device_dispatches.values())
                != ex.last_dispatch_count):
            raise AssertionError(
                f"{label}: {ex.last_sync_count} syncs, "
                f"{ex.last_transfer_bytes} B moved of "
                f"{tp.physical_bytes()} planned, dispatches "
                f"{ex.last_device_dispatches} of {ex.last_dispatch_count}")
        if first is None:
            first = out
        elif not torch.equal(out, first):
            raise AssertionError(f"{label}: run {i} differs from run 0")
    return ex, first, walls


def hetero_summary(label, ex, walls, model_layers=None):
    """Log the placement, segments and transfers of a hetero executor."""
    placement = ex.plan.placement
    per_dev = collections.Counter(a.key for a in
                                  placement.assignments.values())
    per = ""
    if model_layers:
        per = " (" + ", ".join(f"{k[0]}:{k[1]} {n / model_layers:.2f}"
                               for k, n in sorted(per_dev.items())) + \
            " a model layer)"
    moves = {}
    for e in ex.plan.attrs["transfers"].edges:
        moves[(e.tensor, e.dst)] = (e.src[0], e.dst[0], e.nbytes)
    way = collections.Counter()
    for src, dst, nb in moves.values():
        way[f"{src}->{dst}"] += nb
        way[f"{src}->{dst} n"] += 1
    stats = ex.hetero_stats
    log(f"{label}: branches {dict(sorted(per_dev.items()))}{per}; "
        f"{stats.segments} segments ({stats.dynamic_regions} dynamic) on "
        f"{list(stats.devices)}, dispatches a run "
        f"{ex.last_device_dispatches}; {len(moves)} transfers, "
        f"{ex.last_transfer_bytes} B a run "
        f"({', '.join(f'{k}: {way[k]}' for k in sorted(way))}); batched "
        f"groups {stats.batched_groups}, GEMM sites {stats.gemm_sites}; "
        f"wall ms a run {', '.join(f'{w:.3f}' for w in walls)}")


def device_split(ex, env, device):
    """One run with a barrier after every segment (``profile=True``): ms
    per logical device, summed over its segments."""
    from repro_torch.hetero import HeteroExecutor

    prof = HeteroExecutor(ex.plan, profile=True, device=device)
    res = prof(env)
    split = collections.Counter()
    for seg, t in zip(prof.compiled.segments, res.layer_timings):
        split[seg.device] += t.seconds * 1e3
    return dict(split)


def hetero_zoo_phase(bm, device):
    """Hetero A and B: ``multihead_graph(2560, 32, 512)`` placed under the
    permissive profile and under ``H100_CONFIG`` (every branch on the
    card: bit-identical to fused parallax, 2 ``branch_matmul`` launches a
    run); the heterogeneous, cond and while graphs at dim 2560 (their
    control-flow nodes on the host as dynamic regions, against
    ``reference`` on the card at 2e-5, three runs bit-identical, the
    region cache hit on the later runs)."""
    import torch_graph_zoo as tz
    from repro_torch.core import (H100_CONFIG, HardwareProfile,
                                  ParallaxConfig, PlanExecutor, compile_plan)
    from repro_torch.core.executor import to_device
    from repro_torch.hetero import ACCEL

    perm = HardwareProfile("permissive", 0.0, 1.0, 1.0, 1.0)
    g, make = tz.multihead_graph(**PLANNER_GRAPH)
    budget = torch.cuda.mem_get_info(device)[0]
    env = make(np.random.default_rng(0))
    for name, cfg, prof in (
            ("permissive", ParallaxConfig(budget=budget), perm),
            ("H100_CONFIG", H100_CONFIG.with_(budget=budget), None)):
        plan = compile_plan(g, cfg)
        fused = PlanExecutor(plan, device=device)
        card_env = to_device(env, device)
        want = fused(card_env).outputs[g.outputs[0]]
        t0 = time.perf_counter()
        fused(card_env)
        fused_ms = (time.perf_counter() - t0) * 1e3
        ex, got, walls = hetero_runs(
            f"hetero A ({name})", plan, env, device, HETERO_RUNS, prof,
            ((bm, "branch_matmul", 2),))
        hetero_summary(f"hetero A ({name})", ex, walls)
        log(f"hetero A ({name}): branch_matmul launches on this path "
            f"{bm.launches['branch_matmul']} in {HETERO_RUNS} runs")
        if set(ex.last_device_dispatches) != {(ACCEL, 0)}:
            raise AssertionError("hetero A: a branch left the card")
        same = torch.equal(got, want)
        log(f"hetero A ({name}): {'bit-identical to' if same else 'DIFFERS from'}"
            f" fused parallax ({fused_ms:.3f} ms a run with its inputs on "
            f"the card; the hetero runs copy the graph inputs, "
            f"{sum(v.nbytes for v in env.values())} B with the params, "
            f"from the host)")
        if not same:
            raise AssertionError("hetero A differs from fused parallax")
    for name in HETERO_CF_GRAPHS:
        g, make = tz.ALL_ZOO[name](dim=HETERO_CF_DIM)
        env = make(np.random.default_rng(0))
        plan = compile_plan(g, H100_CONFIG.with_(budget=budget))
        ref = PlanExecutor(plan, "reference", device=device)(
            env).outputs[g.outputs[0]]
        ex, got, walls = hetero_runs(f"hetero B ({name})", plan, env,
                                     device, HETERO_RUNS)
        hetero_summary(f"hetero B ({name})", ex, walls)
        cache = ex._hetero.dynamic_cache
        n_dyn = ex.hetero_stats.dynamic_regions
        close = torch.allclose(got.to(device), ref, rtol=2e-5, atol=2e-5)
        log(f"hetero B ({name}): vs reference on the card: max abs "
            f"{(got.to(device) - ref).abs().max().item():.3e}, normwise "
            f"{normwise(got.to(device), ref):.3e} (rtol=atol=2e-5 "
            f"{'holds' if close else 'FAILS'}); {HETERO_RUNS} runs "
            f"bit-identical; region cache: {cache.compile_count} built, "
            f"{cache.trace_count} traced, {cache.hit_count} hits, "
            f"{cache.eager_fallbacks} eager")
        if not close or n_dyn < 1 \
                or cache.hit_count != n_dyn * (HETERO_RUNS - 1):
            raise AssertionError(f"hetero B ({name}) failed")


def hetero_dag(label, cfg, lm, seq, device, configs, check, scan=None,
               dynamic=0):
    """Hetero C-F: ``export_graph`` of ``lm`` at batch
    ``DAG_BATCH`` and ``seq``, planned under each of ``configs`` (names of
    ``repro_torch.core``'s ParallaxConfigs, given the card's free memory
    as budget), run in ``parallax-hetero`` with its
    inputs on the host beside ``reference`` and fused ``parallax`` on the
    card.  ``check(label, hetero, reference)`` holds the logits;
    ``scan``: the ``ssd_scan`` wrapper module (0 launches a hetero run,
    one a layer in fused parallax); ``dynamic``: the host dynamic regions
    the placement must make."""
    from repro_torch import core
    from repro_torch.core import (PlanExecutor, clear_compile_cache,
                                  compile_plan)
    from repro_torch.core.executor import to_device
    from repro_torch.kernels import branch_matmul as bm
    from repro_torch.models.dag_export import export_graph

    g, make = export_graph(cfg, lm, DAG_BATCH, seq)
    env = make(np.random.default_rng(0))
    card_env, env = to_device(env, device), host_env(env)
    params_b = sum(env[t].nbytes for t in g.params)
    budget = torch.cuda.mem_get_info(device)[0]
    for name in configs:
        plan = compile_plan(g, getattr(core, name).with_(budget=budget))
        ref = PlanExecutor(plan, "reference", device=device)(
            card_env).outputs[g.outputs[0]]
        fused = PlanExecutor(plan, device=device)
        fused_ms = []
        for _ in range(HETERO_RUNS):
            before = scan.launches["ssd_scan"] if scan else 0
            t0 = time.perf_counter()
            fused(card_env)
            fused_ms.append((time.perf_counter() - t0) * 1e3)
            if scan and scan.launches["ssd_scan"] - before \
                    != cfg.num_layers:
                raise AssertionError(f"{label}: fused parallax did not "
                                     f"launch ssd_scan once a layer")
        wrappers = [(bm, "branch_matmul", 0)]
        if scan:
            wrappers.append((scan, "ssd_scan", 0))
        ex, got, walls = hetero_runs(f"{label} ({name})", plan, env, device,
                                     HETERO_RUNS, wrappers=wrappers)
        hetero_summary(f"{label} ({name})", ex, walls, dag_layers(cfg)[0])
        cache = ex._hetero.dynamic_cache
        log(f"{label} ({name}): region cache {cache.compile_count} built, "
            f"{cache.trace_count} traced, {cache.hit_count} hits, "
            f"{cache.eager_fallbacks} eager")
        if ex.hetero_stats.dynamic_regions != dynamic:
            raise AssertionError(f"{label}: {ex.hetero_stats.dynamic_regions}"
                                 f" dynamic regions, expected {dynamic}")
        split = device_split(ex, env, device)
        log(f"{label} ({name}): fused parallax on the card "
            f"{', '.join(f'{w:.3f}' for w in fused_ms)} ms a run; "
            f"parallax-hetero moves the params ({params_b} B, not counted "
            f"as transfers) to their consumers' devices every run; "
            f"a run with a barrier after each segment spends ms "
            f"{ {k: round(v, 3) for k, v in sorted(split.items())} }")
        check(f"{label} ({name})", got.to(device), ref)
        del plan, ref, fused, ex, got
    del g, make, env, card_env
    clear_compile_cache()


def normwise_close(tol, argmax=False):
    """Hetero C and F: the output within a normwise ``tol`` of
    ``reference``, with the same argmax where ``argmax``."""
    def check(label, got, ref):
        rel = normwise(got, ref)
        same = not argmax or torch.equal(got.argmax(-1), ref.argmax(-1))
        log(f"{label}: output vs reference on the card: normwise {rel:.3e} "
            f"(tol {tol}), max abs {(got - ref).abs().max().item():.3e}"
            + (f", argmax {'equal' if same else 'DIFFERS'}" if argmax
               else ""))
        if not (rel <= tol and same):
            raise AssertionError(f"{label}: output off reference")
    return check


def logits_allclose(tol):
    """Hetero D-E: the phase's own tolerance against the oracle."""
    def check(label, got, ref):
        ok = torch.allclose(got, ref, rtol=tol, atol=tol)
        log(f"{label}: logits vs the oracle on the card: max abs "
            f"{(got - ref).abs().max().item():.3e}, normwise "
            f"{normwise(got, ref):.3e} (rtol=atol={tol} "
            f"{'holds' if ok else 'FAILS'})")
        if not ok:
            raise AssertionError(f"{label}: logits off the oracle")
    return check


# --------------------------------------------------------------------------
# phases 3d and 10-13: mamba2-370m on ssd_scan
# --------------------------------------------------------------------------

def ssd_inputs(rng, b, S, H, G, N, device, strided):
    """The JAX suite's distributions at head dim SSD_P and d_state N.
    Strided: x, B and C sliced out of one projection-like buffer and dt
    out of a wider one, as the DAG's scan node hands them to the
    kernel."""
    P = SSD_P
    x = rng.standard_normal((b, S, H * P), dtype=np.float32)
    Bm = rng.standard_normal((b, S, G * N), dtype=np.float32)
    Cm = rng.standard_normal((b, S, G * N), dtype=np.float32)
    dt = rng.uniform(0.01, 0.2, (b, S, 2 * H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    if strided:
        buf = torch.tensor(np.concatenate([x, Bm, Cm], -1), device=device)
        x, Bm, Cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
        dt = torch.tensor(dt, device=device)[..., :H]
    else:
        x, Bm, Cm = (torch.tensor(t, device=device) for t in (x, Bm, Cm))
        dt = torch.tensor(dt[..., :H].copy(), device=device)
    return (x.reshape(b, S, H, P), dt, torch.tensor(A, device=device),
            Bm.reshape(b, S, G, N), Cm.reshape(b, S, G, N))


def ssd_bound(b, S, H, G, N):
    """The least work that y from a zero state needs.  Operations: the
    recurrence's (``core.flops.ssd_scan_flops``), one multiply-add a
    (token, head, p, n) folding the token into the state and one reading
    y out of it, the decay kept as a per-token scalar.  The chunked
    algorithm (:func:`ssd_chunked_flops`) computes the same y with more at
    every chunk length.  Bytes: x and y, B and C (per group), dt and A,
    each once."""
    from repro_torch.core.flops import ssd_scan_flops

    flops = ssd_scan_flops(b, S, H, SSD_P, N)
    nbytes = 4 * (2 * b * S * H * SSD_P + 2 * b * S * G * N + b * S * H + H)
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_chunked_flops(b, S, H, G, L, N):
    """The chunked algorithm's own count on these inputs, the kernel's:
    per (batch, group, chunk) C.B^T over the causal triangle 2 L(L+1)/2 N,
    once for the group's H / G heads; per (batch, head, chunk) its product
    with x.dt 2 L(L+1)/2 P; per chunk boundary the state folded in and
    read out, 2 L P N each (no read of the zero start state, no fold of
    the last chunk, whose state is discarded)."""
    P = SSD_P
    tri = L * (L + 1) // 2
    nc = S // L
    return b * (nc * G * 2 * tri * N
                + H * (nc * 2 * tri * P + (nc - 1) * 4 * L * P * N))


def ssd_identities(ss, label, args, L, got):
    """On the card, bit for bit: one batch row alone equals its row of the
    batch, and the first k whole chunks alone equal the first k L
    positions of the full run (a chunk reads only earlier chunks)."""
    x, dt, A, Bm, Cm = args
    b, S = x.shape[:2]
    if b > 1:
        one = ss.ssd_scan(x[b - 1:], dt[b - 1:], A, Bm[b - 1:], Cm[b - 1:], L)
        identical("ssd_scan", f"{label}, row {b - 1} alone vs in the batch "
                  f"of {b}", one[0], got[b - 1])
    k = S // L // 2 * L
    if k:
        prefix = ss.ssd_scan(x[:, :k], dt[:, :k], A, Bm[:, :k], Cm[:, :k], L)
        identical("ssd_scan", f"{label}, the first {k // L} of {S // L} "
                  f"chunks alone vs the full sequence", prefix, got[:, :k])


def ssd_phase(ss, device):
    """ssd_scan against its plain version and the sequential recurrence in
    four cases, bit-identical on a rerun, one batch row alone and a prefix
    of whole chunks; returns (max abs err, timing at the prefill
    shape)."""
    rng = np.random.default_rng(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst, timing = 0.0, None
    for label, b, S, H, G, L, N, strided in SSD_CASES:
        args = ssd_inputs(rng, b, S, H, G, N, device, strided)
        got = ss.ssd_scan(*args, L)
        again = ss.ssd_scan(*args, L)
        for what, want in (("plain", ss.ssd_scan_plain(*args, L)),
                           ("sequential", ss.ssd_scan_ref(*args)[0])):
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL)
            log(f"ssd_scan {label} b={b} S={S} H={H} G={G} L={L} P={SSD_P} "
                f"N={N}{' strided' if strided else ''}: vs {what} max "
                f"abs err {e:.3e} on |y| <= {want.abs().max().item():.2f} "
                f"(rtol=atol={SSD_TOL}: {'holds' if ok else 'FAILS'})")
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with its {what} "
                                     f"version ({label})")
            worst = max(worst, e)
            del want
        if not torch.equal(got, again):
            raise AssertionError("ssd_scan reruns differ")
        ssd_identities(ss, label, args, L, got)
        t = dict(ms=median_ms(lambda: ss.ssd_scan(*args, L), flush),
                 plain_ms=median_ms(lambda: ss.ssd_scan_plain(*args, L),
                                    flush),
                 bound=ssd_bound(b, S, H, G, N), library_ms=None)
        chunked = ssd_chunked_flops(b, S, H, G, L, N)
        log(f"ssd_scan {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}); reruns bit-identical; the chunked "
            f"algorithm's own count {chunked / 1e9:.3f} GFLOP would take "
            f"{chunked / PEAK_FLOPS[torch.float32] * 1e3:.5f} ms at the "
            f"fp32 peak")
        if timing is None:
            timing = t
        del args, got, again
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return worst, timing


def scan_precision(api, params, ss, device):
    """The scan at the model's own inputs: layer 0's operands from one
    bf16 ``prefill_fn`` call, through the kernel and the plain version,
    each against the sequential recurrence in float64."""
    import repro_torch.models.ssm as ssm

    cfg = api.cfg
    batch = prefill_tokens(cfg, device)
    kernel, seen = ssm.ssd_scan, []

    def keep(*args, **kwargs):
        if not seen:
            seen.append(tuple(t.clone() for t in args[:5]))
        return kernel(*args, **kwargs)

    ssm.ssd_scan = keep
    try:
        with torch.no_grad():
            api.prefill_fn(params, batch)
    finally:
        ssm.ssd_scan = kernel
    x, dt, A, Bm, Cm = seen[0]
    L = cfg.ssm.chunk
    cs = torch.cumsum((dt * A).reshape(PREFILL_B, -1, L, dt.shape[-1]), 2)
    exact = ss.ssd_scan_ref(*(t.double() for t in seen[0]))[0]
    errs = {name: normwise(fn(x, dt, A, Bm, Cm, L).double(), exact)
            for name, fn in (("kernel", ss.ssd_scan),
                             ("plain", ss.ssd_scan_plain))}
    log(f"prefill: layer 0's scan at the model's inputs (dt <= "
        f"{dt.max().item():.2f}, A >= {A.min().item():.1f}, chunk-end "
        f"|cumsum| <= {cs[:, :, -1].abs().max().item():.0f}): normwise "
        f"from the float64 recurrence, kernel {errs['kernel']:.3e}, plain "
        f"{errs['plain']:.3e}")
    if not errs["kernel"] <= SSD_TOL:
        raise AssertionError("ssd_scan off the recurrence at the model's "
                             "inputs")


def reuse_requests(vocab):
    """One slot, two tenants: a 40-token prompt, then a 2-token one (under
    the conv window: a stale window would reach its stream)."""
    from repro_torch.runtime.engine import Request

    rng = np.random.default_rng(5)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate((40, 2))]


def serve_one_slot(api, params, reqs):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine

    eng = ContinuousEngine(api, params, device=api.device,
                           config=EngineConfig(
                               hbm_budget=4 << 30, max_batch=1, megastep=8,
                               block_size=BS, max_context=MAX_CONTEXT))
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    eng.assert_quiescent()
    if not all(c.ok for c in done.values()):
        raise AssertionError("one-slot run: a request failed")
    return {k: c.tokens for k, c in done.items()}, eng


def mamba_serve_phase(api, params, calls, ss):
    """Phase 11: the 8-request workload through the paged engine at
    megastep 8 (sharing asked for, and gated off by the per-row state),
    the dense engine at 8 and 1 and the round engine; streams identical,
    no ssd_scan launch (decode is the recurrence); then slot reuse and
    one poisoned megastep."""
    from repro_torch.runtime.faults import FaultEvent, FaultPlane
    from repro_torch.runtime.stepper import Stepper

    resets = [0]
    reset_rows = Stepper.reset_rows

    def counted_reset(self, caches, fresh):
        resets[0] += 1
        return reset_rows(self, caches, fresh)

    runs = (("continuous paged, megastep 8", dict(megastep=8)),
            ("continuous dense, megastep 8", dict(megastep=8, paged=False)),
            ("continuous dense, megastep 1", dict(megastep=1, paged=False)),
            ("round engine", None))
    streams_of = {}
    Stepper.reset_rows = counted_reset
    try:
        for label, knobs in runs:
            calls[0] = resets[0] = 0
            ss.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if knobs is None:
                streams, eng, wall = serve_round(api, params)
            else:
                streams, eng, wall = serve_full_width(api, params,
                                                      sharing=True, **knobs)
                if eng.prefix_sharing or eng.spill_enabled:
                    raise AssertionError("sharing or spill armed for a "
                                         "model with per-row state")
            n_tok = sum(len(t) for t in streams.values())
            log(f"mamba serve: {label}: 8/8 requests, {n_tok} tokens in "
                f"{wall:.3f} s ({n_tok / wall:.1f} tok/s), {eng.dispatches} "
                f"dispatches ({eng.dispatches / n_tok:.4f} per token), "
                f"{resets[0]} reset dispatches, {calls[0]} decode_fn calls, "
                f"ssd_scan launches {ss.launches['ssd_scan']}, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if ss.launches["ssd_scan"] or calls[0] == 0:
                raise AssertionError(f"{label}: ssd_scan launched in decode "
                                     f"or decode_fn never ran")
            if knobs is not None and resets[0] == 0:
                raise AssertionError(f"{label}: no reset dispatch")
            streams_of[label] = streams
    finally:
        Stepper.reset_rows = reset_rows
    base = streams_of[runs[0][0]]
    for label, streams in streams_of.items():
        same = streams == base
        log(f"mamba serve: {label}: streams "
            f"{'bit-identical to' if same else 'DIFFER from'} the paged run")
        if not same:
            raise AssertionError(f"{label}: streams differ")
    first, second = reuse_requests(api.cfg.vocab_size)
    solo, _ = serve_one_slot(api, params, [second])
    both, eng = serve_one_slot(api, params, [first, second])
    same = both[1] == solo[1]
    log(f"mamba serve: one slot, request 1 after request 0: stream "
        f"{'equal to' if same else 'DIFFERS from'} its solo run "
        f"({eng.dispatches} dispatches)")
    if not same:
        raise AssertionError("slot reuse leaked state")
    plane = FaultPlane([FaultEvent(3, "poison", rows=(0, 1, 2))])
    streams, eng, _ = serve_full_width(api, params, 8, True, faults=plane)
    same = streams == base
    log(f"mamba serve: poisoned megastep at iteration 3: watchdog trips "
        f"{eng.watchdog_trips}, megastep fallbacks {eng.megastep_fallbacks}, "
        f"rows failed {eng.rows_failed}; streams "
        f"{'bit-identical to' if same else 'DIFFER from'} the clean run")
    if not (same and eng.megastep_fallbacks == 1 and eng.rows_failed == 0):
        raise AssertionError("the poisoned megastep did not fall back "
                             "bit-identically")


def mamba_planner_phase(ss, device):
    """Phase 12: the mamba2-370m DAG at full width and depth (fp32), batch
    1, seq 256, through the planner: reference and fused parallax against
    the op-by-op oracle, one ssd_scan launch per layer per run; then
    hetero E on its first ``MAMBA_HETERO_LAYERS`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-370m")
    lm = build_model(cfg, device=device, dtype="float32").init(
        torch.Generator(device=device).manual_seed(0))
    dag_check("mamba planner", cfg, lm, DAG_SEQ, PLANNER_MODES, MAMBA_RUNS,
              device, tol=SSD_TOL, unsupported=".ssd_scan", scan=ss)
    hetero_dag("hetero E",
               dataclasses.replace(cfg, num_layers=MAMBA_HETERO_LAYERS), lm,
               DAG_SEQ, device, ("MOBILE_CONFIG",), logits_allclose(SSD_TOL),
               scan=ss)
    del lm
    gc.collect()
    torch.cuda.empty_cache()


def mamba_phases(ss, calls_wrap, device):
    """Phases 10-13 on mamba2-370m at full width: prefill_fn on ssd_scan,
    the serving engines, the planner DAG, the CLI.  Returns the launches
    of one prefill_fn call (the kernel's main path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import build_model

    cfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_state {cfg.ssm.d_state}, {n_params / 1e6:.1f} M "
        f"params in {api.dtype}, init {time.perf_counter() - t0:.1f} s")
    def plain_half_chunk(x, dt, A, B, C, chunk):
        return ssd_scan_plain(x, dt, A, B, C, chunk // 2)

    def plain_y_bf16(x, dt, A, B, C, chunk):
        return ssd_scan_plain(x, dt, A, B, C, chunk).bfloat16().float()

    def plain_dt_bf16(x, dt, A, B, C, chunk):   # x, B, C are bf16 values
        return ssd_scan_plain(x, dt.bfloat16().float(), A, B, C, chunk)

    ssm = "repro_torch.models.ssm"
    batch = prefill_tokens(cfg, device)
    launched = prefill_phase(
        api, params, batch, "ssd_scan",
        (ssm, "ssd_scan", ssd_scan_plain), MAMBA_XCHECK, device,
        tol=MAMBA_PREFILL_TOL, readings=(
            (f"at chunk {cfg.ssm.chunk // 2}",
             (ssm, "ssd_scan", plain_half_chunk), False),
            ("faulty: with y rounded to bf16",
             (ssm, "ssd_scan", plain_y_bf16), True),
            ("faulty: on dt rounded to bf16",
             (ssm, "ssd_scan", plain_dt_bf16), True)))
    scan_precision(api, params, ss, device)
    step_profile(api, params, device)
    # the bf16 projections at the tensor-core peak plus 48 scans at their
    # bound: in_proj and out_proj over every token, the tied head over the
    # last token only (the embedding is a gather), over 989 TFLOP/s; and
    # ssd_bound per layer
    proj = sum(p.numel() for n, p in params.named_parameters()
               if n.endswith(("in_proj", "out_proj")))
    matmul_ms = (2 * (proj * PREFILL_B * PREFILL_S
                      + params.embed.numel() * PREFILL_B)
                 / PEAK_FLOPS[torch.bfloat16] * 1e3)
    scan_ms = cfg.num_layers * ssd_bound(PREFILL_B, PREFILL_S, 32, 1,
                                         SSD_N)[0]
    device_profile(f"{cfg.name} prefill_fn (B={PREFILL_B}, S={PREFILL_S})",
                   lambda: api.prefill_fn(params, batch), 2,
                   (matmul_ms + scan_ms, f"projection ({matmul_ms:.3f} ms) "
                    f"+ scan ({scan_ms:.3f} ms)"),
                   (("ssd_scan", ss.launches),))
    calls = calls_wrap(api)
    mamba_serve_phase(api, params, calls, ss)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    mamba_planner_phase(ss, device)

    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import serve
    done = serve("mamba2-370m", engine_mode="continuous")
    if not all(c.ok for c in done.values()):
        raise AssertionError("CLI serve did not complete every request")
    log(f"cli: serve('mamba2-370m', engine_mode='continuous') completed "
        f"{len(done)} requests")
    argv = ["--arch", "mamba2-370m", "--engine", "round", "--requests", "4",
            "--max-new", "8"]
    log(f"cli: python -m repro_torch.launch.serve {' '.join(argv)}")
    serve_main(argv)
    return launched


# --------------------------------------------------------------------------
# phases 14-19: MoE on branch_matmul (dbrx-132b, kimi-k2)
# --------------------------------------------------------------------------

def routing_counts(gen, E, k, T, device):
    """Per-expert row counts of a top-k routing of T tokens over E experts
    on random router logits, clamped to the dropless capacity, as
    ``moe_ragged`` hands them to the kernel."""
    from repro_torch.models.moe import Buckets

    logits = torch.randn((T, E), generator=gen, device=device)
    b = Buckets(torch.topk(logits, k, -1).indices, E)
    return b.counts.clamp(max=b.cap).int()


def layer_summary(label, layer):
    """Log a dbrx or kimi MoE layer's three launches, summed; returns the
    kernels-line timing (library: ``torch._grouped_mm`` where it exists,
    else ``torch.bmm``; bound: the routed work)."""
    grouped = "n/a" if layer["grouped_ms"] is None \
        else f"{layer['grouped_ms']:.4f} ms"
    log(f"branch_matmul per {label}: kernel {layer['ms']:.4f} ms, plain "
        f"{layer['plain_ms']:.4f} ms, torch.bmm {layer['library_ms']:.4f} "
        f"ms, torch._grouped_mm {grouped}, bound {layer['bound']:.5f} ms "
        f"({'/'.join(sorted(layer['by']))}), "
        f"routed-work bound {layer['routed']:.5f} ms "
        f"({'/'.join(sorted(layer['routed_by']))})")
    return dict(ms=layer["ms"], plain_ms=layer["plain_ms"],
                library_ms=layer["library_ms"] if layer["grouped_ms"] is None
                else layer["grouped_ms"],
                bound=(layer["routed"], "/".join(sorted(layer["routed_by"]))))


def moe_kernel_phase(bm, device):
    """Phase 14: ``branch_matmul`` in bf16 at the MoE decode path's
    shapes, one projection each, twice: with every row counted (all M)
    and with the counts of a top-k routing of B tokens (the path's);
    returns (max abs err, timing of one dbrx MoE layer's three launches at
    decode with the routing's counts).  The prefill shapes are checked at
    the capacities and counts the prefill runs, in phases 16 and 18."""
    gen = torch.Generator(device=device).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst = 0.0
    layers = {"all rows": {}, "routed": {}}
    for label, G, M, K, N, k in MOE_CASES:
        # outputs of std 0.5, as in branch_phase
        x = torch.randn((G, M, K), generator=gen, device=device,
                        dtype=torch.bfloat16)
        w = torch.randn((G, K, N), generator=gen, device=device,
                        dtype=torch.bfloat16).mul_(1 / (2 * np.sqrt(K)))
        extra = torch.randn((G, MOE_EXTRA_ROWS, K), generator=gen,
                            device=device, dtype=torch.bfloat16)
        for kind, counts in (
                ("all rows", torch.full((G,), M, dtype=torch.int32,
                                        device=device)),
                ("routed", routing_counts(gen, G, k, M, device))):
            case = gemm_case(bm, f"MoE {label}, {kind}", x, w, flush,
                             MOE_KERNEL_ITERS, extra, counts)
            worst = max(worst, case["err"])
            if label.startswith("dbrx"):
                add_timing(layers[kind], case,
                           2 if "gate" in label else 1)      # up too
        del x, w, extra
        torch.cuda.empty_cache()
    layer_summary("dbrx MoE layer at decode, every row counted (B=8: "
                  "gate, up, down at capacity 8)", layers["all rows"])
    timing = layer_summary("dbrx MoE layer at decode, a routing's counts "
                           "(B=8, top-4 of 16)", layers["routed"])
    return worst, timing


class RoutingRecorder:
    """While active, ``repro_torch.models.moe.route`` records per call the
    sorted expert ids of each token and the gap between its k-th and
    (k+1)-th router probability; the first call's input is kept."""

    def __init__(self):
        import repro_torch.models.moe as moe_mod

        self.mod, self.route = moe_mod, moe_mod.route
        self.calls, self.first_x = [], None

    def __enter__(self):
        def recorded(params, cfg, x):
            out = self.route(params, cfg, x)
            if self.first_x is None:
                self.first_x = x.clone()
            probs = torch.softmax(x.float() @ params.router.float(), -1)
            top = torch.topk(probs, cfg.moe.num_experts_per_tok + 1,
                             -1).values
            self.calls.append((out[1].sort(-1).values,
                               top[:, -2] - top[:, -1]))
            return out

        self.mod.route = recorded
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


@contextlib.contextmanager
def plain_experts(bm):
    """A context in which ``moe_ragged`` runs ``branch_matmul_plain``."""
    import repro_torch.models.moe as moe_mod

    kernel = moe_mod.branch_matmul
    moe_mod.branch_matmul = bm.branch_matmul_plain
    try:
        yield
    finally:
        moe_mod.branch_matmul = kernel


def routing_flips(a, b):
    """Per MoE layer: tokens routed to another expert set in run b than
    in run a, and a's probability gaps (k-th minus (k+1)-th) at them."""
    out = []
    for (ia, ga), (ib, _) in zip(a.calls, b.calls):
        moved = (ia != ib).any(-1)
        gaps = ga[moved]
        out.append((int(moved.sum()), gaps.max().item() if len(gaps)
                    else None))
    return out


def moe_prefill_flops(cfg, Bn, S):
    """Matrix products of one prefill_fn call: projections over every
    token, causal attention, the router, the dense layers' MLPs, the
    k routed experts (and the shared one) per token; the head on the
    last token only."""
    d, D = cfg.d_model, cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    m = cfg.moe
    T = Bn * S
    flops = 2 * Bn * d * cfg.vocab_size
    for i in range(cfg.num_layers):
        flops += 2 * T * (d * (H + 2 * K) * D + H * D * d)
        flops += 2 * Bn * H * S * S * D        # causal QK^T and PV, halved
        if cfg.is_moe_layer(i):
            f = m.d_ff_expert
            flops += 2 * T * d * m.num_experts
            flops += 2 * T * 3 * d * f * (m.num_experts_per_tok
                                          + m.num_shared_experts)
        else:
            flops += 2 * T * 3 * d * cfg.d_ff
    return flops


def moe_layer_check(bm, cfg, moe, x, recorded, label, device):
    """One MoE layer of a ``prefill_fn`` call at its own inputs x (T, d):
    ``moe_ragged`` through the kernel against the plain GEMM (2e-2, the
    routing equal to the call's ``recorded`` sorted expert ids); then each
    of its three ``branch_matmul`` launches on the layer's weights and
    bucketed rows, at the dropless capacity the call ran.  Returns the
    max abs err."""
    import torch.nn.functional as F

    import repro_torch.models.moe as moe_mod

    # room for the plain GEMM's fp32 copy of a weight tensor (21 GiB at
    # kimi's widths) beside the model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    with torch.no_grad():
        y_k, _ = moe_mod.moe_ragged(moe, cfg, x)
        with plain_experts(bm):
            y_p, _ = moe_mod.moe_ragged(moe, cfg, x)
        idx = moe_mod.route(moe, cfg, x)[1]
        b = moe_mod.Buckets(idx, cfg.moe.num_experts)
        torch.cuda.synchronize()
    e = (y_k.float() - y_p.float()).abs().max().item()
    same = torch.equal(idx.sort(-1).values, recorded)
    log(f"moe prefill: {cfg.name} {label}'s MoE at its own inputs "
        f"(T={x.shape[0]}, experts' rows {b.counts.min().item()}-"
        f"{b.counts.max().item()}, dropless capacity {b.cap}): kernel vs "
        f"plain GEMM max abs {e:.3e} on |y| <= "
        f"{y_p.float().abs().max().item():.2f} (tol {TOL[x.dtype]}), "
        f"normwise {normwise(y_k, y_p):.3e}; routing "
        f"{'equal' if same else 'DIFFERS'}")
    if not (torch.allclose(y_k.float(), y_p.float(), rtol=TOL[x.dtype],
                           atol=TOL[x.dtype]) and same):
        raise AssertionError("moe_ragged's kernel path off its plain path")
    del y_k, y_p
    dt, E = x.dtype, cfg.moe.num_experts
    counts = b.counts.clamp(max=b.cap).int()
    rows = int(counts.sum())
    tile = bf16_tile_rows(b.cap)
    log(f"moe prefill: {cfg.name} {label}: {E * b.cap} bucket rows, "
        f"{int((-(-counts // tile) * tile).sum())} computed in row tiles of "
        f"{tile}, {rows} routed ({E * b.cap / rows:.2f}x routed in the "
        f"buckets); {int((counts > 0).sum())} of {E} experts with a row")
    layer, worst = {}, e
    with torch.no_grad():
        xb = b.gather(x)
        ws = [moe.w_gate.to(dt), moe.w_up.to(dt)]
        for name, w in zip(("gate", "up"), ws):
            extra = torch.randn((E, MOE_EXTRA_ROWS, xb.shape[2]),
                                generator=gen, device=device, dtype=dt)
            case = gemm_case(bm, f"MoE {cfg.name} prefill {name}", xb, w,
                             flush, MOE_KERNEL_ITERS, extra, counts)
            add_timing(layer, case)
            worst = max(worst, case["err"])
        h = F.silu(bm.branch_matmul(xb, ws[0], counts)) \
            * bm.branch_matmul(xb, ws[1], counts)
        del xb, ws
        extra = torch.randn((E, MOE_EXTRA_ROWS, h.shape[2]), generator=gen,
                            device=device, dtype=dt)
        case = gemm_case(bm, f"MoE {cfg.name} prefill down", h,
                         moe.w_down.to(dt), flush, MOE_KERNEL_ITERS, extra,
                         counts)
        add_timing(layer, case)
        worst = max(worst, case["err"])
    layer_summary(f"{cfg.name} MoE layer at prefill (T={x.shape[0]}: gate, "
                  f"up, down at capacity {b.cap} with the layer's counts)",
                  layer)
    return worst


def moe_serve_phase(api, params, calls, bm, pa, da, identities=True):
    """Phases 15 and 18: the 8-request workload through ContinuousEngine
    (paged, megastep 8, sharing), launch counts zeroed just before and
    read just after: per decode_fn call three ``branch_matmul`` launches
    per MoE layer and one of each paged kernel per layer.  With
    ``identities``, the same streams at megastep 1, sharing off, on the
    dense cache (N=8 and 1) and, compared, through the round engine.
    Returns the main run's branch_matmul launches."""
    cfg = api.cfg
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    calls[0] = 0
    bm.reset_launches()
    pa.reset_launches()
    da.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streams, eng, wall = serve_full_width(api, params, 8, True)
    launched = {**bm.launches, **pa.launches, **da.launches}
    n_tok = sum(len(t) for t in streams.values())
    log(f"moe serve: {cfg.name}: 8/8 requests, {n_tok} tokens in "
        f"{wall:.3f} s ({n_tok / wall:.1f} tok/s), {eng.dispatches} "
        f"dispatches ({eng.dispatches / n_tok:.4f} per token), "
        f"{eng.megasteps} megasteps, {calls[0]} decode_fn calls, shared "
        f"block hits {eng.kv.shared_block_hits}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launched}")
    want = {"branch_matmul": 3 * n_moe * calls[0],
            "paged_decode_attention": cfg.num_layers * calls[0],
            "paged_append": cfg.num_layers * calls[0],
            "decode_attention": 0}
    if launched != want or calls[0] == 0:
        raise AssertionError(f"{cfg.name}: launches {launched}, expected "
                             f"{want}")
    if eng.kv.shared_block_hits == 0:
        raise AssertionError("prefix sharing never engaged")
    if identities:
        for megastep, sharing in ((1, True), (8, False)):
            other, e2, w2 = serve_full_width(api, params, megastep,
                                             sharing)
            same = other == streams
            log(f"moe identity: megastep {megastep}, sharing {sharing}: "
                f"streams {'bit-identical' if same else 'DIFFER'} "
                f"({w2:.3f} s, {e2.dispatches} dispatches)")
            if not same:
                raise AssertionError("greedy streams differ")
        dense_serve_phase(api, params, calls, streams, pa, da)
    return launched["branch_matmul"]


def moe_prefill_phase(api, params, bm, fa, device):
    """Phase 16: prefill_fn at B=1, S=2048 through ``branch_matmul`` and
    ``flash_attention``; layer 0's MoE at its own inputs against the
    plain GEMM (routing equal); the logits against the call with the
    plain GEMM patched in, routing flips counted per layer; a device
    profile of the call.  Returns the MoE checks' max abs err."""
    cfg = api.cfg
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MOE_PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)
    batch = {"tokens": tokens}
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bm.reset_launches()
        fa.reset_launches()
        with RoutingRecorder() as rec:
            logits = api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        launched = (bm.launches["branch_matmul"],
                    fa.launches["flash_attention"])
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(MOE_PREFILL_RUNS):
            t0 = time.perf_counter()
            api.prefill_fn(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with plain_experts(bm), RoutingRecorder() as rec_plain:
            plain = api.prefill_fn(params, batch)
        torch.cuda.synchronize()
    if logits.shape != (MOE_PREFILL_B, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("prefill_fn: malformed logits")
    if launched != (3 * n_moe, cfg.num_layers):
        raise AssertionError(f"prefill_fn: launches (branch_matmul, "
                             f"flash_attention) {launched}, expected "
                             f"{(3 * n_moe, cfg.num_layers)}")
    first = next(layer for layer in params.layers if layer.kind[1] == "moe")
    err = moe_layer_check(bm, cfg, first.moe, rec.first_x, rec.calls[0][0],
                          "layer 0", device)
    rel = normwise(logits, plain)
    same_argmax = torch.equal(logits.argmax(-1), plain.argmax(-1))
    flips = routing_flips(rec, rec_plain)
    log(f"moe prefill: {cfg.name} prefill_fn B={MOE_PREFILL_B} "
        f"S={PREFILL_S}: {launched[0]} branch_matmul and {launched[1]} "
        f"flash_attention launches per call, {float(np.median(walls)):.3f} "
        f"ms per call (median of {MOE_PREFILL_RUNS}, {min(walls):.3f}-"
        f"{max(walls):.3f}), peak device memory {peak / 2**30:.2f} GiB; vs "
        f"the plain GEMM: logits normwise {rel:.3e} (tol {PREFILL_TOL}), "
        f"argmax {'equal' if same_argmax else 'DIFFERS'}"
        f"; tokens routed elsewhere per MoE layer (largest gap among "
        f"them): {flips}")
    if not rel <= PREFILL_TOL:
        raise AssertionError("prefill_fn off its plain-GEMM version")
    del plain, rec, rec_plain
    bound_ms = moe_prefill_flops(cfg, MOE_PREFILL_B, PREFILL_S) \
        / PEAK_FLOPS[torch.bfloat16] * 1e3
    device_profile(f"{cfg.name} prefill_fn (B={MOE_PREFILL_B}, "
                   f"S={PREFILL_S})",
                   lambda: api.prefill_fn(params, batch), 1,
                   (bound_ms, "matrix-product"),
                   (("branch_matmul", bm.launches),
                    ("flash_attention", fa.launches)))
    return err


def moe_fp32_phase(bm, device):
    """Phases 16b and 17: dbrx-132b at full width, ``DBRX_FP32_LAYERS``
    deep, in fp32: prefill_fn against the plain GEMM at 2e-4 (routing
    flips counted); then its DAG through the planner, ``reference`` and
    fused ``parallax`` within 2e-4 of the op-by-op oracle; then hetero
    D."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              num_layers=DBRX_FP32_LAYERS)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device, dtype="float32")
    lm = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.num_layers} of 40 layers, "
        f"fp32, {sum(p.numel() for p in lm.parameters()) / 1e9:.2f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MOE_PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)
    with torch.no_grad():
        bm.reset_launches()
        with RoutingRecorder() as rec:
            got = api.prefill_fn(lm, {"tokens": tokens})
        launched = bm.launches["branch_matmul"]
        with plain_experts(bm), RoutingRecorder() as rec_plain:
            want = api.prefill_fn(lm, {"tokens": tokens})
        torch.cuda.synchronize()
    rel = normwise(got, want)
    log(f"moe prefill: fp32 model, {cfg.num_layers} layers: "
        f"{launched} branch_matmul launches; kernel vs plain GEMM logits "
        f"normwise {rel:.3e} (tol {PREFILL_TOL_FP32}), max abs "
        f"{(got - want).abs().max().item():.3e}; tokens routed elsewhere "
        f"per layer: {routing_flips(rec, rec_plain)}")
    if not rel <= PREFILL_TOL_FP32 or launched != 3 * cfg.num_layers:
        raise AssertionError("fp32 prefill_fn off its plain-GEMM version")
    del got, want, rec, rec_plain

    stats = dag_check("moe planner", cfg, lm, MOE_DAG_SEQ, PLANNER_MODES,
                      MAMBA_RUNS, device, tol=PREFILL_TOL_FP32,
                      unsupported=".router")
    log(f"moe planner: {stats.gemm_sites} GEMM sites: the "
        f"{cfg.moe.num_experts} expert chains a layer run branch by branch "
        f"(their nodes close over their weights and gate/up carries the "
        f"SwiGLU, as in the JAX exporter, so no node is a pure 2-D matmul)")
    hetero_dag("hetero D", cfg, lm, MOE_DAG_SEQ, device, ("MOBILE_CONFIG",),
               logits_allclose(PREFILL_TOL_FP32), dynamic=cfg.num_layers)
    del api, lm
    gc.collect()
    torch.cuda.empty_cache()


def kimi_phase(bm, pa, da, fa, device):
    """Phase 18: kimi-k2 at full width, ``KIMI_LAYERS`` deep (the dense
    first layer, then one 384-expert layer with its shared expert): one
    prefill_fn call, its MoE layer at its own inputs against the plain
    GEMM and on 16 tokens against ``moe_dense`` (all experts), profiles
    of a prefill call and a decode step, and one paged serve run, with
    launch counts.  Returns the MoE checks' max abs err."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                              num_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.num_layers} of 61 layers "
        f"({[layer.kind for layer in params.layers]}), "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.2f} B params "
        f"in {api.dtype}, init {time.perf_counter() - t0:.1f} s")
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MOE_PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)
    with torch.no_grad():
        bm.reset_launches()
        fa.reset_launches()
        with RoutingRecorder() as rec:
            t0 = time.perf_counter()
            logits = api.prefill_fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launched = (bm.launches["branch_matmul"],
                    fa.launches["flash_attention"])
        moe = params.layers[1].moe
        x = rec.first_x[:16]
        y_k, _ = moe_mod.moe_ragged(moe, cfg, x)
        y_d, _ = moe_mod.moe_dense(moe, cfg, x)
        torch.cuda.synchronize()
    rel = normwise(y_k, y_d)
    log(f"kimi: layer 1's MoE ({cfg.moe.num_experts} experts, top-"
        f"{cfg.moe.num_experts_per_tok}, shared expert) on 16 tokens: "
        f"moe_ragged (branch_matmul) vs moe_dense (every expert) normwise "
        f"{rel:.3e} (tol {PREFILL_TOL})")
    if not rel <= PREFILL_TOL:
        raise AssertionError("kimi: moe_ragged off moe_dense")
    log(f"kimi: prefill_fn B={MOE_PREFILL_B} S={PREFILL_S}: {wall:.3f} ms "
        f"(first call), launches (branch_matmul, flash_attention) "
        f"{launched}")
    if logits.shape != (MOE_PREFILL_B, cfg.vocab_size) \
            or not torch.isfinite(logits).all() or launched != (3, 2):
        raise AssertionError("kimi prefill_fn: malformed logits or "
                             "launches")
    del x, y_k, y_d, logits
    err = moe_layer_check(bm, cfg, moe, rec.first_x, rec.calls[0][0],
                          "layer 1", device)
    del rec
    bound_ms = moe_prefill_flops(cfg, MOE_PREFILL_B, PREFILL_S) \
        / PEAK_FLOPS[torch.bfloat16] * 1e3
    device_profile(f"{cfg.name} prefill_fn (B={MOE_PREFILL_B}, "
                   f"S={PREFILL_S})",
                   lambda: api.prefill_fn(params, {"tokens": tokens}), 1,
                   (bound_ms, "matrix-product"),
                   (("branch_matmul", bm.launches),
                    ("flash_attention", fa.launches)))
    step_profile(api, params, device, (
        ("branch_matmul", bm.launches),
        ("paged_decode_attention", pa.launches),
        ("decode_attention", da.launches)))
    calls = count_calls(api)
    moe_serve_phase(api, params, calls, bm, pa, da, identities=False)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    return err


def moe_phases(bm, pa, da, fa, device):
    """Phases 15-19 after the kernel cases: dbrx-132b (serve, prefill),
    the fp32 check and the MoE DAG, kimi-k2, the CLI.  Returns the
    branch_matmul launches of the dbrx serve run (the MoE main path) and
    the max abs err of the prefill MoE checks."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("dbrx-132b"),
                              num_layers=DBRX_LAYERS)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"model: {cfg.name} full width, {cfg.num_layers} of 40 layers, "
        f"d_model {cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.num_experts_per_tok}, {n_params / 1e9:.2f} B params in "
        f"{api.dtype} (router fp32), init {time.perf_counter() - t0:.1f} s")
    calls = count_calls(api)
    launched = moe_serve_phase(api, params, calls, bm, pa, da)
    err = moe_prefill_phase(api, params, bm, fa, device)
    step_profile(api, params, device, (
        ("branch_matmul", bm.launches),
        ("paged_decode_attention", pa.launches),
        ("decode_attention", da.launches)))
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    moe_fp32_phase(bm, device)
    err = max(err, kimi_phase(bm, pa, da, fa, device))

    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import serve
    done = serve("dbrx-132b", engine_mode="continuous")
    if not all(c.ok for c in done.values()):
        raise AssertionError("CLI serve did not complete every request")
    log(f"cli: serve('dbrx-132b', engine_mode='continuous') completed "
        f"{len(done)} requests")
    argv = ["--arch", "kimi-k2-1t-a32b", "--requests", "4", "--max-new",
            "8"]
    log(f"cli: python -m repro_torch.launch.serve {' '.join(argv)}")
    serve_main(argv)
    return launched, err


# --------------------------------------------------------------------------
# phases 21-22: whisper-tiny, the encoder-decoder (slice 7)
# --------------------------------------------------------------------------

def sdpa_cross(q, k, v):
    """The library yardstick of the cross case: one SDPA call, no mask."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[:, :, None], k, v)[:, :, 0]


def whisper_kernel_phase(da, fa, device):
    """Phase 21: ``flash_attention`` at the encoder's shape and
    ``decode_attention`` at the decoder's two shapes, each against its
    plain version, launched twice and bit-identical, timed beside its
    bound and one SDPA call; ``flash_attention`` at S = 1 on the cross
    shape timed beside ``decode_attention``.  Returns {name: max abs
    err}."""
    w = WHISPER
    Bw, Hw, Dw, T = w["B"], w["H"], w["D"], w["T_ENC"]
    gen = torch.Generator(device=device).manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    err = {"decode_attention": 0.0, "flash_attention": 0.0}

    def twice(name, label, fn):
        got = fn()
        same = torch.equal(got, fn())
        log(f"{name} whisper {label}: two launches "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name} differs from itself ({label})")
        return got

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        q, k, v = (torch.randn(Bw, Hw, T, Dw, generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        label = f"encoder B={Bw} H=K={Hw} S=T={T} D={Dw} non-causal"
        got = twice("flash_attention", f"{label} {dt}",
                    lambda: fa.flash_attention(q, k, v, causal=False))
        want = fa.flash_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        err["flash_attention"] = max(err["flash_attention"], check(
            "flash_attention", f"whisper {label}", got, want, dtype))
        del want
        bf16_vs_fp32("flash_attention", f"whisper {label}", got,
                     lambda *a: fa.flash_attention_plain(*a, causal=False),
                     q, k, v)
        time_case(
            "flash_attention", f"whisper {label} {dt}",
            lambda: fa.flash_attention(q, k, v, causal=False),
            lambda: fa.flash_attention_plain(q, k, v, causal=False),
            lambda: sdpa_flash(q, k, v, False, 0),
            flash_bound(q, k, False, 0), flush)
        del q, k, v

        # the decoder: cross (T_ENC slots, every one valid) and self
        q = torch.randn(Bw, Hw, Dw, generator=gen, device=device).to(dtype)
        for label, slots, n in (
                (f"cross T={T} all valid", T, T - 1),
                (f"self T={w['T_DEC']} cache_len {WHISPER_SELF_LEN}",
                 w["T_DEC"], WHISPER_SELF_LEN)):
            k, v = (torch.randn(Bw, slots, Hw, Dw, generator=gen,
                                device=device).to(dtype).transpose(1, 2)
                    for _ in range(2))
            pos = torch.arange(slots, dtype=torch.int32, device=device)
            lens = torch.full((Bw,), n, dtype=torch.int32, device=device)
            got = twice("decode_attention", f"{label} {dt}",
                        lambda: da.decode_attention(q, k, v, pos, lens))
            want = da.decode_attention_plain(q, k, v, pos, lens)
            torch.cuda.synchronize()
            err["decode_attention"] = max(err["decode_attention"], check(
                "decode_attention", f"whisper {label}", got, want, dtype))
            bf16_vs_fp32("decode_attention", f"whisper {label}", got,
                         da.decode_attention_plain, q, k, v, pos, lens)
            for b in (0, Bw - 1):       # B = 1 splits as B = 8 does
                one = da.decode_attention(q[b:b + 1], k[b:b + 1],
                                          v[b:b + 1], pos, lens[b:b + 1])
                identical("decode_attention", f"whisper {label} {dt}, row "
                          f"{b} alone (B=1) vs in the batch of {Bw}",
                          one[0], got[b])
            if dtype != torch.bfloat16:
                continue
            cross = slots == T
            time_case(
                "decode_attention", f"whisper {label} {dt}",
                lambda: da.decode_attention(q, k, v, pos, lens),
                lambda: da.decode_attention_plain(q, k, v, pos, lens),
                (lambda: sdpa_cross(q, k, v)) if cross
                else (lambda: sdpa_decode(q, k, v, pos, lens, 0)),
                dense_decode_bound(q, k, pos, lens, 0), flush)
            if cross:
                # the road not taken: flash_attention's one query row
                q1 = q[:, :, None]
                got1 = fa.flash_attention(q1, k, v, causal=False)
                err["flash_attention"] = max(err["flash_attention"], check(
                    "flash_attention", f"whisper cross S=1 T={T}", got1,
                    fa.flash_attention_plain(q1, k, v, causal=False),
                    dtype))
                bf16_vs_fp32("flash_attention", f"whisper cross S=1 T={T}",
                             got1, lambda *a: fa.flash_attention_plain(
                                 *a, causal=False), q1, k, v)
                time_case(
                    "flash_attention", f"whisper cross S=1 T={T} {dt}",
                    lambda: fa.flash_attention(q1, k, v, causal=False),
                    lambda: fa.flash_attention_plain(q1, k, v,
                                                     causal=False),
                    lambda: sdpa_flash(q1, k, v, False, 0),
                    flash_bound(q1, k, False, 0), flush)
    del flush
    torch.cuda.empty_cache()
    return err


@contextlib.contextmanager
def plain_attention(da, fa):
    """Both attention kernels' plain versions patched into the model
    path (``attend_bshd`` and ``models.attention``'s decode calls)."""
    import importlib

    fmod = importlib.import_module(FLASH_MODULE)
    amod = importlib.import_module("repro_torch.models.attention")
    saved = fmod.flash_attention, amod.decode_attention
    fmod.flash_attention = fa.flash_attention_plain
    amod.decode_attention = (
        lambda q, k, v, pos, lens, window=0, tile=BS:
        da.decode_attention_plain(q, k, v, pos, lens, window))
    try:
        yield
    finally:
        fmod.flash_attention, amod.decode_attention = saved


def kernel_counts(mods):
    return {name: n for m in mods for name, n in m.launches.items()}


def whisper_greedy(api, params, frames, vector, mods):
    """Greedy decode of ``WHISPER_NEW`` tokens a row after
    ``prefill_encdec``, through ``decode_fn`` with a scalar or a vector
    ``cache_len`` (``active`` all true).  Launch counts set to 0 just
    before and read just after.  Returns (streams (B, n), first logits,
    wall s (with the encoder pass), launches, peak bytes, ms a
    decode_fn call)."""
    from repro_torch.models import encdec
    from repro_torch.runtime.sampling import greedy_serving

    cfg, device = api.cfg, api.device
    Bw = frames.shape[0]
    tok = torch.full((Bw, 1), WHISPER_SOT, dtype=torch.int32,
                     device=device)
    active = torch.ones(Bw, dtype=torch.bool, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    caches = api.init_caches(Bw, WHISPER["T_DEC"])
    _, caches = encdec.prefill_encdec(params, cfg, frames, caches)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for m in mods:
        m.reset_launches()
    out, first = [], None
    for i in range(WHISPER_NEW):
        batch = {"tokens": tok, "cache_len": i}
        if vector:
            batch = {"tokens": tok, "active": active, "cache_len": torch.full(
                (Bw,), i, dtype=torch.int32, device=device)}
        logits, caches = api.decode_fn(params, caches, batch)
        first = logits if first is None else first
        tok = greedy_serving(logits)[:, None]
        out.append(tok)
    streams = torch.cat(out, 1).cpu()
    t2 = time.perf_counter()
    return (streams, first, t2 - t0, kernel_counts(mods),
            torch.cuda.max_memory_allocated(),
            (t2 - t1) / WHISPER_NEW * 1e3)


def whisper_prefill_flops(cfg, Bn, S):
    """Operations of a Whisper prefill_fn call: the encoder's GEMMs and
    attention, and every decoder layer's cross K/V (the first decoder
    token's few are left out)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    enc = (2 * Bn * S * d * (4 * d + 2 * cfg.d_ff)
           + 4 * Bn * cfg.num_heads * S * S * hd)
    cross = 2 * Bn * S * d * 2 * cfg.num_kv_heads * hd
    return cfg.encoder_layers * enc + cfg.num_layers * cross


def decode_step_bytes(params, caches, position):
    """What one Whisper ``decode_fn`` step must read: the token table
    (also the vocab head), the decoder blocks, the final norm, one row of
    ``dec_pos``, the cross K/V and the self caches' slots up to
    ``position``; and write: each layer's new K/V row and the logits.
    The encoder's weights and the rest of ``dec_pos`` are not read."""
    def nbytes(ps):
        return sum(p.numel() * p.element_size() for p in ps)

    item = params.embed.element_size()
    B = caches["cross_k"].shape[1]
    kv_row = sum(c["k"][:, 0].nbytes for c in caches["self"])
    return (nbytes([params.embed]) + nbytes(params.decoder.parameters())
            + nbytes(params.dec_final.parameters())
            + params.dec_pos[0].nbytes + caches["cross_k"].nbytes
            + caches["cross_v"].nbytes + 2 * kv_row * (position + 1)
            + B * params.embed.shape[0] * item)


def whisper_reference_phase(device):
    """The reduced fp32 model on the card (kernels) against the same
    weights on the CPU (plain versions): prefill and 4 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec, stub_audio_frontend

    cfg = get_config("whisper-tiny").reduced()
    gpu, cpu = build_model(cfg, device=device), build_model(cfg,
                                                            device="cpu")
    p_gpu = gpu.init(torch.Generator(device=device).manual_seed(1))
    p_cpu = cpu.init(None)
    p_cpu.load_state_dict(p_gpu.state_dict())
    frames = stub_audio_frontend(torch.Generator().manual_seed(2), cfg, 4,
                                 cfg.encoder_seq)
    tok = torch.zeros(4, 1, dtype=torch.int32)
    worst = []
    lg = gpu.prefill_fn(p_gpu, {"frames": frames.to(device),
                                "tokens": tok.to(device)})
    lc = cpu.prefill_fn(p_cpu, {"frames": frames, "tokens": tok})
    worst.append((lg.cpu() - lc).abs().max().item())
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-5, atol=2e-5)
    cg, cc = gpu.init_caches(4, 16), cpu.init_caches(4, 16)
    _, cg = encdec.prefill_encdec(p_gpu, cfg, frames.to(device), cg)
    _, cc = encdec.prefill_encdec(p_cpu, cfg, frames, cc)
    for step in range(WHISPER_REF_STEPS):
        lg, cg = gpu.decode_fn(p_gpu, cg, {"tokens": tok.to(device),
                                           "cache_len": step})
        lc, cc = cpu.decode_fn(p_cpu, cc, {"tokens": tok,
                                           "cache_len": step})
        worst.append((lg.cpu() - lc).abs().max().item())
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-5, atol=2e-5)
        tok = lc.argmax(-1, keepdim=True).int()
    log(f"whisper reference: reduced fp32, card vs CPU: prefill_fn max abs "
        f"err {worst[0]:.3e}, {WHISPER_REF_STEPS} decode steps "
        f"{max(worst[1:]):.3e} (tol 2e-5)")


def whisper_phases(da, fa, device, others):
    """Phase 22: whisper-tiny at full width (4 + 4 layers, d_model 384,
    bf16, random weights from ``torch.Generator`` seed 0) on 8 stub
    utterances of 1500 frames: ``prefill_fn`` (4 ``flash_attention``
    and 8 ``decode_attention`` launches a call, logits against the plain
    versions), greedy decode through ``decode_fn`` (8
    ``decode_attention`` launches a call, nothing else; scalar and
    vector streams bit-identical), the reduced model against the CPU,
    and the encoder DAG through the planner and ``parallax-hetero``.
    ``others``: the other kernel modules, which must not launch.
    Returns the launch counts of one prefill_fn and one decode_fn call."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec, stub_audio_frontend

    mods = (fa, da) + tuple(others)
    cfg = get_config("whisper-tiny")
    w = WHISPER
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    frames = stub_audio_frontend(torch.Generator(device=device)
                                 .manual_seed(1), cfg, w["B"], w["T_ENC"])
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params.parameters()) / 1e6:.2f} M params "
        f"in {api.dtype}, init {time.perf_counter() - t0:.1f} s")
    batch = {"frames": frames, "tokens": torch.full(
        (w["B"], 1), WHISPER_SOT, dtype=torch.int32, device=device)}
    with torch.no_grad():
        api.prefill_fn(params, batch)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in mods:
            m.reset_launches()
        logits = api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        prefill_counts = kernel_counts(mods)
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(PREFILL_RUNS):
            t1 = time.perf_counter()
            api.prefill_fn(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        with plain_attention(da, fa):
            plain = api.prefill_fn(params, batch)
    want = dict.fromkeys(prefill_counts, 0)
    want.update(flash_attention=cfg.encoder_layers,
                decode_attention=2 * cfg.num_layers)
    rel = normwise(logits, plain)
    log(f"whisper prefill: prefill_fn B={w['B']} S_enc={w['T_ENC']}: "
        f"launches {prefill_counts}, {float(np.median(walls)):.3f} ms a "
        f"call (median of {PREFILL_RUNS}, {min(walls):.3f}-"
        f"{max(walls):.3f}), peak device memory {peak / 2**30:.3f} GiB; "
        f"vs both plain versions: normwise {rel:.3e} (tol {PREFILL_TOL}), "
        f"max abs {(logits.float() - plain.float()).abs().max().item():.3e}")
    if logits.shape != (w["B"], cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("whisper prefill_fn: malformed logits")
    if prefill_counts != want:
        raise AssertionError(f"whisper prefill_fn launches {prefill_counts}"
                             f", expected {want}")
    if not rel <= PREFILL_TOL:
        raise AssertionError("whisper prefill_fn off its plain versions")
    api32 = build_model(cfg, device=device, dtype="float32")
    p32 = api32.init(None)
    p32.load_state_dict(params.state_dict())
    with torch.no_grad():
        ref32 = api32.prefill_fn(p32, batch)
        with plain_attention(da, fa):
            plain32 = api32.prefill_fn(p32, batch)
    rel32 = normwise(ref32, plain32)
    log(f"whisper prefill: fp32 model, same weights: kernels vs plain "
        f"versions normwise {rel32:.3e} (tol {PREFILL_TOL_FP32}); bf16 vs "
        f"fp32 evaluation {normwise(logits, ref32):.3e}")
    if not rel32 <= PREFILL_TOL_FP32:
        raise AssertionError("fp32 whisper prefill_fn off its plain "
                             "versions")
    del api32, p32, ref32, plain32, plain
    torch.cuda.empty_cache()

    runs = {}
    with torch.no_grad():
        for vector in (False, True):
            runs[vector] = whisper_greedy(api, params, frames, vector, mods)
    streams, first, wall, counts, peak, step_ms = runs[False]
    n_tok = streams.numel()
    want = dict.fromkeys(counts, 0)
    want["decode_attention"] = 2 * cfg.num_layers * WHISPER_NEW
    same = torch.equal(streams, runs[True][0])
    log(f"whisper decode: {w['B']} utterances x {WHISPER_NEW} greedy tokens "
        f"through decode_fn (scalar cache_len): {n_tok} tokens in "
        f"{wall:.3f} s with the encoder pass ({n_tok / wall:.1f} tok/s), "
        f"{step_ms:.3f} ms a decode_fn call with its sampling, peak "
        f"device memory {peak / 2**30:.3f} GiB, launches {counts} "
        f"({counts['decode_attention'] / WHISPER_NEW:.0f} decode_attention "
        f"a call); vector cache_len: {runs[True][2]:.3f} s "
        f"({runs[True][5]:.3f} ms a call), streams "
        f"{'bit-identical' if same else 'DIFFER'}; first step's logits "
        f"{'bit-identical to' if torch.equal(first, logits) else 'DIFFER from'}"
        f" prefill_fn's")
    if counts != want or runs[True][3] != want:
        raise AssertionError(f"whisper decode launches {counts} / "
                             f"{runs[True][3]}, expected {want}")
    if not same or not torch.equal(first, logits):
        raise AssertionError("whisper decode streams differ")

    # where the time goes: one prefill_fn call, one decode_fn step
    wrappers = (("flash_attention", fa.launches),
                ("decode_attention", da.launches))
    device_profile(
        f"{cfg.name} prefill_fn (B={w['B']}, {w['T_ENC']} frames)",
        lambda: api.prefill_fn(params, batch), 3,
        (whisper_prefill_flops(cfg, w["B"], w["T_ENC"])
         / PEAK_FLOPS[torch.bfloat16] * 1e3, "operations"), wrappers)
    caches = api.init_caches(w["B"], w["T_DEC"])
    with torch.no_grad():
        _, caches = encdec.prefill_encdec(params, cfg, frames, caches)
    step = {"tokens": batch["tokens"], "cache_len": WHISPER_SELF_LEN}
    device_profile(
        f"{cfg.name} decode_fn (B={w['B']}, position {WHISPER_SELF_LEN})",
        lambda: api.decode_fn(params, caches, step), 5,
        (decode_step_bytes(params, caches, WHISPER_SELF_LEN)
         / HBM_BYTES_PER_S * 1e3, "bytes"),
        wrappers)
    del api, params, frames, batch, logits, runs, first, caches
    gc.collect()
    torch.cuda.empty_cache()

    whisper_reference_phase(device)

    # the encoder DAG at full width (fp32): planner and parallax-hetero
    lm = build_model(cfg, device=device, dtype="float32").init(
        torch.Generator(device=device).manual_seed(0))
    modes = {k: v for k, v in MODES.items() if k != "fused, kernel off"}
    dag_check("whisper DAG", cfg, lm, w["T_ENC"], modes, RUNS_B, device,
              arena=True)
    hetero_dag("hetero F", cfg, lm, w["T_ENC"], device,
               ("MOBILE_CONFIG", "H100_CONFIG"),
               normwise_close(WHISPER_NORMWISE))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {f"prefill_fn {k}": v for k, v in prefill_counts.items() if v} \
        | {f"decode_fn {k}": v // WHISPER_NEW for k, v in counts.items()
           if v}


# --------------------------------------------------------------------------
# phases 28-33: qwen2-vl-2b, the vision-language model (slice 9)
# --------------------------------------------------------------------------

def qwen_kernel_phase(pa, da, fa, device):
    """Phase 28: the four attention kernels at qwen2-vl-2b's shapes (GQA
    12/2, D = 128), in bf16 and fp32, through phase 3's
    :class:`AttentionCases`: ``flash_attention`` at the prefill (B=2,
    S=T=2048, causal), ``decode_attention`` at the serve phase's (B=8,
    MAX_CONTEXT slots, ragged lengths) with its identities, and
    ``paged_decode_attention`` on a block pool laid from the same K/V
    against its plain version and with its identities; ``paged_append``
    (C=1) bit for bit against its plain version.  bf16 timed (medians by
    CUDA events, L2 flushed) beside the bound and the library call.
    Returns ({name: max abs err}, {PERF.md row: timing})."""
    H_, K, D_ = QWEN["H"], QWEN["K"], QWEN["D"]
    rng = np.random.default_rng(9)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = AttentionCases(pa, da, fa, rng, flush)
    err = {"paged_decode_attention": 0.0, "paged_append": 0.0}
    rows, timed = {}, {}
    T = MAX_CONTEXT
    arange = torch.arange(T, dtype=torch.int32, device=device)
    flash = f"qwen2-vl B={FA_B} {H_}/{K} S=T={PREFILL_S} D={D_} causal"
    at = f"qwen2-vl B={B} {H_}/{K} D={D_} T={T}, every row at 100"
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        cases.flash(flash, FA_B, H_, K, PREFILL_S, PREFILL_S, D_, True, 0,
                    dtype, timed=timed if bf16 else None)
        torch.cuda.empty_cache()

        # the decode kernels: a dense cache and a pool of the same K/V
        q, k, v, lens = dense_decode_case(rng, B, H_, K, D_, T, dtype,
                                          device)
        label = f"qwen2-vl B={B} {H_}/{K} D={D_} T={T} ragged"
        cases.dec(label, q, k, v, arange, lens, 0)
        pools, tables = cases.dec_identities(q, k, v, lens, (0,))
        paged = pa.paged_decode_attention(q, *pools, tables, lens)
        err["paged_decode_attention"] = max(
            err["paged_decode_attention"], check(
                "paged_decode_attention", label, paged,
                pa.paged_decode_attention_plain(q, *pools, tables, lens, 0),
                dtype))
        bf16_vs_fp32("paged_decode_attention", label, paged,
                     lambda q_, kp, vp: pa.paged_decode_attention_plain(
                         q_, kp, vp, tables, lens, 0), q, *pools)
        paged_identities(pa, q, *pools, tables, lens, 0, rng)
        if bf16:
            at100 = torch.full((B,), 100, dtype=torch.int32, device=device)
            cases.dec(at, q, k, v, arange, at100, 0, timed=timed)
            rows["4v"] = paged_timing(pa, at, q, *pools, tables, at100, 0,
                                      flush)
            rows["4v"]["library_ms"] = None
        del q, k, v, pools, paged

        # paged_append, the decode step's C = 1
        k1, v1, kn, vn, tables, lens, nv = append_case(rng, dtype, device,
                                                       K=K, D_=D_)
        k2, v2 = k1.clone(), v1.clone()
        pa.paged_append(k1, v1, kn, vn, tables, lens, nv)
        pa.paged_append_plain(k2, v2, kn, vn, tables, lens, nv)
        torch.cuda.synchronize()
        identical("paged_append", f"qwen2-vl B={B} C=1 K={K} D={D_} {dt}, "
                  f"n_valid {nv.tolist()}: pools vs the plain version",
                  torch.stack([k1, v1]), torch.stack([k2, v2]))
        if bf16:
            nbytes = 4 * kn.numel() * kn.element_size() + 4 * B * 3
            t = dict(ms=median_ms(lambda: pa.paged_append(
                         k1, v1, kn, vn, tables, lens, nv), flush),
                     plain_ms=median_ms(lambda: pa.paged_append_plain(
                         k2, v2, kn, vn, tables, lens, nv), flush),
                     bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                     library_ms=None)
            log(f"paged_append qwen2-vl B={B} C=1 K={K} D={D_} {dt}: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                f"{t['bound'][0]:.6f} ms (bytes)")
            rows["5v"] = t
        del k1, v1, k2, v2
    rows["2v"], rows["3v"] = timed[flash], timed[at]
    del flush
    torch.cuda.empty_cache()
    return err | cases.err, rows


def qwen_prefill_flops(cfg, Bn, S):
    """Operations of a Qwen2-VL prefill_fn call: every layer's GEMMs (QKV
    with its biases, out, SwiGLU MLP) and causal attention, and the last
    position's tied vocab head."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    H_, K = cfg.num_heads, cfg.num_kv_heads
    gemm = 2 * Bn * S * (d * (H_ + 2 * K) * hd + H_ * hd * d
                         + 3 * d * cfg.d_ff)
    attn = 4 * Bn * H_ * hd * flash_pairs(S, S, True, 0)
    return cfg.num_layers * (gemm + attn) + 2 * Bn * d * cfg.vocab_size


def qwen_batch(api, gen, Bn, device):
    """``Bn`` rows of the stub vision frontend (``num_frontend_tokens``
    patch embeddings and the 3-stream positions) and PREFILL_S - n
    seeded text tokens."""
    from repro_torch.models import stub_vision_frontend

    cfg = api.cfg
    n = cfg.num_frontend_tokens
    emb, pos3 = stub_vision_frontend(gen, cfg, Bn, PREFILL_S)
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (Bn, PREFILL_S - n)), dtype=torch.int32,
        device=device)
    return {"tokens": tokens, "frontend_embeds": emb, "positions3": pos3}


def qwen_prefill_phase(api, params, fa, device):
    """Phase 29: :func:`prefill_phase` on PREFILL_B rows of 1024 stub
    vision patches and 1024 text tokens with the stub's 3-stream
    positions (28 ``flash_attention`` launches a call and no other
    kernel), with two planted faults the bf16 limit must see: the M-RoPE
    sections in reverse order ((24, 24, 16) for (16, 24, 24): the same
    sum, the streams' bands moved) and an attention that puts
    query head h on KV head h % K in place of h // G; then a profile of
    the call.  Returns its launches."""
    from repro_torch.models.common import apply_mrope

    cfg = api.cfg
    G = cfg.num_heads // cfg.num_kv_heads
    reverse = tuple(cfg.mrope_sections[::-1])
    batch = qwen_batch(api, torch.Generator(device=device).manual_seed(1),
                       PREFILL_B, device)

    def misordered(x, positions3, sections, inv_freq):
        return apply_mrope(x, positions3, reverse, inv_freq)

    def heads_interleaved(q, k, v, causal=True, window=0):
        return fa.flash_attention_plain(q, k.repeat(1, G, 1, 1),
                                        v.repeat(1, G, 1, 1), causal, window)

    launched = prefill_phase(
        api, params, batch, "flash_attention",
        (FLASH_MODULE, "flash_attention", fa.flash_attention_plain),
        XCHECK_PROMPT, device, readings=(
            (f"faulty: M-RoPE sections {reverse}",
             ("repro_torch.models.attention", "apply_mrope", misordered),
             True),
            ("faulty: query head h on KV head h % K",
             (FLASH_MODULE, "flash_attention", heads_interleaved), True)))
    device_profile(
        f"{cfg.name} prefill_fn (B={PREFILL_B}, S={PREFILL_S})",
        lambda: api.prefill_fn(params, batch), 3,
        (qwen_prefill_flops(cfg, PREFILL_B, PREFILL_S)
         / PEAK_FLOPS[torch.bfloat16] * 1e3, "operations"),
        (("flash_attention", fa.launches),))
    return launched


def qwen_serve_phase(api, params, pa, da, device):
    """Phase 30: :func:`serve_phase` on qwen2-vl-2b (28 ``paged_append``
    and 28 ``paged_decode_attention`` launches a ``decode_fn`` call,
    streams bit-identical at megastep 1, with sharing off, on the dense
    cache with 28 ``decode_attention`` a call and through the round
    engine); one ``decode_fn`` call with explicit equal ``positions3``
    bit-identical to the call without them, paged and dense; profiles of
    a decode step.  Returns the paged launches of one call."""
    cfg = api.cfg
    launched, n_calls = serve_phase(api, params, pa, da)
    log(f"qwen2-vl dense: {launched.pop('decode_attention')} "
        f"decode_attention launches in the three dense runs")

    # explicit positions3 equal to cache_len on every stream change nothing
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 1)), dtype=torch.int32, device=device)
    at100 = torch.full((B,), 100, dtype=torch.int32, device=device)
    step = {"tokens": tokens, "cache_len": at100,
            "active": torch.ones(B, dtype=torch.bool, device=device),
            "block_tables": torch.arange(B * BPR, dtype=torch.int32,
                                         device=device).reshape(B, BPR)}
    with torch.no_grad():
        for label, init in (
                ("paged", lambda: api.init_paged_caches(B, B * BPR, BS)),
                ("dense", lambda: api.init_caches(B, MAX_CONTEXT,
                                                  tile=BS))):
            a, _ = api.decode_fn(params, init(), step)
            b, _ = api.decode_fn(params, init(), dict(
                step, positions3=at100[None, :, None].expand(3, B, 1)))
            identical("qwen2-vl decode_fn", f"{label}, explicit positions3 "
                      f"= cache_len vs none", a, b)
    step_profile(api, params, device, (
        ("paged_decode_attention", pa.launches),
        ("decode_attention", da.launches)))
    return {k: v // n_calls for k, v in launched.items()}


def qwen_train_phase(api, params, fa, ss, bm, device):
    """Phase 31: ``make_train_step`` on ``api.loss_fn`` at full width,
    B=QWEN_TRAIN_B rows of 1024 stub vision patches and 1024 text tokens
    (labels for the text only, from ``SyntheticTokens(seed=0)``), AdamW
    on fp32 masters: step 1 against the plain versions
    (``first_step_check``: 56 ``flash_attention`` launches), then
    QWEN_TRAIN_STEPS steps (each launching 56, step 1 bit-identical to
    the checked one) with peak memory, and a profiled step."""
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.models import stub_vision_frontend
    from repro_torch.training import (OptConfig, init_opt_state,
                                      make_train_step)

    cfg = api.cfg
    n = cfg.num_frontend_tokens
    batch = to_device(next(SyntheticTokens(cfg.vocab_size, PREFILL_S - n,
                                           QWEN_TRAIN_B, seed=0)), device)
    batch["frontend_embeds"], batch["positions3"] = stub_vision_frontend(
        torch.Generator(device=device).manual_seed(2), cfg, QWEN_TRAIN_B,
        PREFILL_S)
    label = (f"{cfg.name} B={QWEN_TRAIN_B} S={PREFILL_S} ({n} vision + "
             f"{PREFILL_S - n} text)")
    want = expected_train_launches(cfg)
    first = first_step_check(api, params, batch, fa, ss, bm, want, label)
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=2)
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(api, opt_cfg)

    def run(record):
        nonlocal params, state
        for i in range(QWEN_TRAIN_STEPS):
            t1 = time.perf_counter()
            params, state, m = step(params, state, batch)
            m = {k: float(v) for k, v in m.items()}
            m["seconds"] = time.perf_counter() - t1
            record(i, params, state, m)

    tokens = QWEN_TRAIN_B * PREFILL_S
    total = train_run(label, run, want, (fa, ss, bm), first.item(), tokens,
                      QWEN_TRAIN_STEPS)
    device_profile(f"{label} train step", lambda: step(params, state, batch),
                   1, train_step_bound(params, tokens),
                   (("flash_attention", fa.launches),), grad=True)
    del state, step, batch
    free()
    return total["flash_attention"] // QWEN_TRAIN_STEPS


def qwen_phases(pa, da, fa, ss, bm, device):
    """Phases 28-33: qwen2-vl-2b at full width (28 layers, d_model 1536,
    GQA 12/2 heads of 128, bf16, random weights from ``torch.Generator``
    seed 0): the kernels at its shapes, ``prefill_fn`` with the stub
    vision frontend, the serving engines, training, and its DAG through
    the planner and ``parallax-hetero``.  Returns ({PERF.md row: timing},
    {name: max abs err}, launches a call)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    err, rows = qwen_kernel_phase(pa, da, fa, device)
    cfg = get_config("qwen2-vl-2b")
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim()}, M-RoPE {cfg.mrope_sections}, "
        f"{n_params / 1e9:.3f} B params in {api.dtype} (ModelConfig."
        f"param_count {cfg.param_count() / 1e9:.3f} B), init "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {"prefill_fn flash_attention": qwen_prefill_phase(
        api, params, fa, device)}
    launches |= {f"decode_fn {k}": v for k, v in qwen_serve_phase(
        api, params, pa, da, device).items()}
    launches["train step flash_attention"] = qwen_train_phase(
        api, params, fa, ss, bm, device)
    del api, params
    free()

    # the DAG at full width (fp32): planner and parallax-hetero
    lm = build_model(cfg, device=device, dtype="float32").init(
        torch.Generator(device=device).manual_seed(0))
    modes = {k: v for k, v in MODES.items() if k != "fused, kernel off"}
    dag_check("qwen2-vl DAG", cfg, lm, QWEN_DAG_SEQ, modes, RUNS_B, device,
              arena=True)
    hetero_dag("hetero G", cfg, lm, QWEN_DAG_SEQ, device,
               ("MOBILE_CONFIG", "H100_CONFIG"),
               normwise_close(HETERO_NORMWISE, argmax=True))
    del lm
    free()
    log(f"qwen2-vl phases: {time.perf_counter() - t_phase:.1f} s")
    return rows, err, launches


# --------------------------------------------------------------------------
# phases 34-36: the distributed layer (slice 10)
# --------------------------------------------------------------------------

CHUNK_ATT = dict(B=1, H=32, D=80, S=4096, chunk_q=512, chunk_k=1024)
EP_CASES = ((4, "replicated"), (2048, "a2a"))   # dbrx-132b's MoE layer
#: the dry-run cases on the 16x16 mesh, each in a child process
DRYRUN_CASES = (("dbrx-132b", "decode_32k"), ("jamba-v0.1-52b", "long_500k"),
                ("stablelm-3b", "train_4k"))
CALIBRATE_S = 4096                 # stablelm-3b prefill_fn, B=1
CARD_GB = 80e9


def dryrun_child(argv) -> int:
    """``chip_smoke.py --dryrun arch shape``: one case of the dry-run on
    the production mesh; ``--dryrun calibrate``: stablelm-3b
    ``prefill_fn`` at B=1, S=CALIBRATE_S with the chunked flag on, on a
    (1, 1) fake mesh.  Prints the record as JSON on the last line.  No
    card: fake tensors only."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.set_num_threads(2)
    from repro_torch.launch import dryrun

    if argv[0] != "calibrate":
        rec = dryrun.run_case(argv[0], argv[1], save=False)
        print(json.dumps(rec))
        return 0 if rec["status"] == "ok" else 1
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import runtime_flags

    mesh = make_fake_mesh((1, 1), ("data", "model"))
    shape = InputShape("prefill_4k", CALIBRATE_S, 1, "prefill")
    mode = dryrun.shared_fake_mode()
    runtime_flags.chunked_attention = True
    fn, args = dryrun.plan_entry(get_config("stablelm-3b"), shape, mesh,
                                 mode)
    trace, arg_bytes, out_bytes, seconds = dryrun.measure(
        fn, args, mesh, mode, train=False)
    print(json.dumps({"argument_size_bytes": arg_bytes,
                      "output_size_bytes": out_bytes,
                      "temp_size_bytes": trace.peak_bytes,
                      "flops": trace.flops, "seconds": seconds}))
    return 0


def start_dryruns():
    """The dry-run children (no card: CUDA hidden from them)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for case in DRYRUN_CASES + (("calibrate",),):
        jobs[case] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dryrun", *case],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    return jobs


def finish_dryrun(job, label):
    out, err = job.communicate(timeout=600)
    if job.returncode != 0:
        raise AssertionError(f"dry-run {label} failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def chunked_attention_phase(fa, device):
    """Phase 34.  Returns the ``flash_attention`` launches of the flagged
    ``self_attention`` call."""
    from repro_torch.configs import get_config
    from repro_torch.models import runtime_flags
    from repro_torch.models.attention import (Attention, attend_chunked,
                                              self_attention)

    c = CHUNK_ATT
    gen = torch.Generator(device=device).manual_seed(34)
    q, k, v = (torch.randn((c["B"], c["S"], c["H"], c["D"]), generator=gen,
                           device=device, dtype=torch.bfloat16)
               for _ in range(3))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def chunked():
        return attend_chunked(q, k, v, causal=True, chunk_q=c["chunk_q"],
                              chunk_k=c["chunk_k"])

    def kernel():
        return fa.attend_bshd(q, k, v, causal=True)

    with torch.no_grad():
        got = {"attend_chunked": chunked(), "flash_attention": kernel()}
        want = fa.flash_attention_plain(
            *(t.float().transpose(1, 2) for t in (q, k, v)),
            causal=True).transpose(1, 2)
        for name, out in got.items():
            rel = normwise(out, want)
            log(f"chunked attention: {name} (B={c['B']}, H=K={c['H']}, "
                f"D={c['D']}, S={c['S']}, causal, bf16) normwise "
                f"{rel:.3e} against the plain version in fp32 on the same "
                f"bf16 inputs (tol {BF16_NORMWISE})")
            if not rel <= BF16_NORMWISE:
                raise AssertionError(f"{name} off the fp32 evaluation")
        del want, got
        bound = flash_bound(q.transpose(1, 2), k.transpose(1, 2), True, 0)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        t_chunk = median_ms(chunked, flush, 10)
        t_kernel = median_ms(kernel, flush, 10)
        t_sdpa = median_ms(lambda: sdpa_flash(qh, kh, vh, True, 0), flush,
                           10)
        del qh, kh, vh
        log(f"chunked attention: attend_chunked {t_chunk:.4f} ms, "
            f"flash_attention kernel {t_kernel:.4f} ms, SDPA is_causal "
            f"(B, H, S, D) {t_sdpa:.4f} ms, bound {bound[0]:.5f} ms "
            f"({bound[1]})")

        cfg = get_config("stablelm-3b")
        attn = Attention(cfg, gen, device, torch.bfloat16)
        x = torch.randn((c["B"], c["S"], cfg.d_model), generator=gen,
                        device=device, dtype=torch.bfloat16)
        pos = torch.arange(c["S"], device=device)[None, :]
        off = self_attention(attn, cfg, x, pos)
        saved = (runtime_flags.chunk_q, runtime_flags.chunk_k)
        try:
            runtime_flags.chunked_attention = True
            runtime_flags.chunk_q, runtime_flags.chunk_k = \
                c["chunk_q"], c["chunk_k"]
            fa.reset_launches()
            on = self_attention(attn, cfg, x, pos)
            torch.cuda.synchronize()
            launched = fa.launches["flash_attention"]
        finally:
            runtime_flags.chunked_attention = False
            runtime_flags.chunk_q, runtime_flags.chunk_k = saved
    log(f"chunked attention: self_attention at stablelm-3b's width with "
        f"the chunked flag on: {launched} flash_attention launch, "
        f"{'bit-identical' if torch.equal(on, off) else 'DIFFERENT'} to "
        f"the flag off")
    if launched != 1 or not torch.equal(on, off):
        raise AssertionError("the chunked flag moved the card off the "
                             "flash_attention kernel")
    return launched


def moe_ep_phase(bm, device):
    """Phase 35.  Returns (branch_matmul launches a call, max abs err)."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config("dbrx-132b")
    mesh = make_host_mesh()                      # NCCL, (1, 1) on one card
    gen = torch.Generator(device=device).manual_seed(35)
    layer = moe_mod.MoE(cfg, gen, device, torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst, per_call = 0.0, set()
    for T, regime in EP_CASES:
        x = torch.randn((T, cfg.d_model), generator=gen, device=device,
                        dtype=torch.bfloat16)
        with torch.no_grad():
            stats = {}
            bm.reset_launches()
            y, aux = moe_mod.moe_ep(layer, cfg, x, mesh, stats=stats)
            torch.cuda.synchronize()
            n = bm.launches["branch_matmul"]
            per_call.add(n)
            if regime == "replicated":
                y_ref, aux_ref = moe_mod.moe_ragged(layer, cfg, x)
                against = "moe_ragged"
            else:
                with plain_experts(bm):
                    y_ref, aux_ref = moe_mod.moe_ep(layer, cfg, x, mesh)
                against = "moe_ep on the plain GEMM"
            e = (y.float() - y_ref.float()).abs().max().item()
            t_ep = median_ms(lambda: moe_mod.moe_ep(layer, cfg, x, mesh),
                             flush, MOE_KERNEL_ITERS)
            t_rag = median_ms(lambda: moe_mod.moe_ragged(layer, cfg, x),
                              flush, MOE_KERNEL_ITERS)

            def ep_plain():
                with plain_experts(bm):
                    return moe_mod.moe_ep(layer, cfg, x, mesh)
            t_plain = median_ms(ep_plain, flush, MOE_KERNEL_ITERS)
        ok = (stats["regime"] == regime and n == 3
              and torch.allclose(y.float(), y_ref.float(), rtol=TOL[x.dtype],
                                 atol=TOL[x.dtype])
              and torch.equal(aux, aux_ref))
        log(f"moe_ep: dbrx-132b MoE layer, T={T}, {stats['regime']} "
            f"regime on a (1, 1) NCCL mesh: {n} branch_matmul launches, "
            f"{int(stats['dropped'])} pairs dropped, against {against} "
            f"max abs {e:.3e} (tol {TOL[x.dtype]}), normwise "
            f"{normwise(y, y_ref):.3e}, aux {'equal' if torch.equal(aux, aux_ref) else 'DIFFERS'}; "
            f"{t_ep:.4f} ms a call, on the plain GEMM {t_plain:.4f} ms, "
            f"moe_ragged {t_rag:.4f} ms")
        if not ok:
            raise AssertionError(f"moe_ep {regime} regime off its check")
        worst = max(worst, e)
    del layer
    free()
    torch.distributed.destroy_process_group()
    return per_call.pop(), worst


def dryrun_summary(label, rec):
    rl, mem = rec["roofline"], rec["memory_analysis"]
    coll = ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in
                     sorted(rec["collective_bytes"].items()))
    log(f"dry-run {label} ({rec['mesh']}{'/' + rec['variant'] if rec['variant'] else ''}): "
        f"{rec['per_device_gb']:.3f} GiB a device of the card's "
        f"{CARD_GB / 2**30:.1f} GiB (arguments "
        f"{mem['argument_size_bytes'] / 2**30:.3f}, temp "
        f"{mem['temp_size_bytes'] / 2**30:.3f}); roofline from the data "
        f"sheet: compute {rl['compute_s']:.4f} s, memory "
        f"{rl['memory_s']:.4f} s, collective {rl['collective_s']:.4f} s "
        f"({rl['dominant']}); collectives {coll}; dispatch "
        f"{rec['lower_s']} s")
    if rec["per_device_gb"] * 2**30 > CARD_GB:
        log(f"dry-run {label}: does not fit one card's 80 GB")


def calibrate_phase(pred, fa, device):
    """Phase 36's calibration: the dry-run's prediction against the same
    step on the card.  Returns the flash_attention launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, runtime_flags

    free()
    cfg = get_config("stablelm-3b")
    m0 = torch.cuda.memory_allocated()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.tensor(np.random.default_rng(36).integers(
        0, cfg.vocab_size, (1, CALIBRATE_S)), dtype=torch.int32,
        device=device)
    inputs = sum(p.numel() * p.element_size() for p in params.parameters())
    inputs += tokens.numel() * tokens.element_size()
    held = torch.cuda.memory_allocated() - m0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        runtime_flags.chunked_attention = True
        fa.reset_launches()
        with torch.no_grad():
            logits = api.prefill_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        runtime_flags.chunked_attention = False
    launched = fa.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - m0
    predicted = pred["argument_size_bytes"] + pred["temp_size_bytes"]
    log(f"calibration: stablelm-3b prefill_fn B=1, S={CALIBRATE_S}, "
        f"chunked flag on: predicted argument bytes "
        f"{pred['argument_size_bytes']}, inputs on the card {inputs} "
        f"({held} held by the allocator); predicted peak "
        f"{predicted / 2**30:.3f} GiB (temp "
        f"{pred['temp_size_bytes'] / 2**30:.3f}), measured "
        f"max_memory_allocated {peak / 2**30:.3f} GiB, ratio "
        f"{predicted / peak:.3f}; {launched} flash_attention launches, "
        f"logits finite {bool(torch.isfinite(logits).all())}; the dry-run "
        f"took {pred['seconds']:.1f} s")
    if pred["argument_size_bytes"] != inputs:
        raise AssertionError("the dry-run's argument bytes are not the "
                             "inputs' on the card")
    if launched != cfg.num_layers or not torch.isfinite(logits).all():
        raise AssertionError("calibration prefill off its kernel path")
    del api, params, logits
    free()
    return launched


def distributed_phases(fa, bm, device):
    """Phases 34-36; returns their launch counts.  The dry-run children
    start after the timed phases 34 and 35, whose host-bound calls they
    would otherwise compete with for the CPU."""
    t_phase = time.perf_counter()
    launches = {"self_attention flash_attention (chunked flag)":
                chunked_attention_phase(fa, device)}
    launches["moe_ep branch_matmul"], err = moe_ep_phase(bm, device)
    jobs = start_dryruns()
    try:
        for case in DRYRUN_CASES:
            dryrun_summary(" x ".join(case), finish_dryrun(jobs[case],
                                                           case))
        pred = finish_dryrun(jobs[("calibrate",)], "calibrate")
    finally:
        for job in jobs.values():
            if job.poll() is None:
                job.kill()
                job.wait()
    launches["calibration prefill_fn flash_attention"] = calibrate_phase(
        pred, fa, device)
    log(f"distributed phases: {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# --------------------------------------------------------------------------
# phases 23-27: training (slice 8)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def patched_kernels(flash, scan, gemm):
    """``flash``, ``scan`` and ``gemm`` patched into the training path in
    place of the three differentiable kernels' wrappers, each where the
    models look it up: ``flash_attention`` in its module (``attend_bshd``
    calls it there), ``ssd_scan`` in ``models.ssm``, ``branch_matmul`` in
    ``models.moe``."""
    import importlib

    mods = [(importlib.import_module(m), n) for m, n in (
        (FLASH_MODULE, "flash_attention"),
        ("repro_torch.models.ssm", "ssd_scan"),
        ("repro_torch.models.moe", "branch_matmul"))]
    saved = [getattr(m, n) for m, n in mods]
    for (m, n), fn in zip(mods, (flash, scan, gemm)):
        setattr(m, n, fn)
    try:
        yield
    finally:
        for (m, n), fn in zip(mods, saved):
            setattr(m, n, fn)


def plain_kernels(fa, ss, bm):
    """The three kernels' plain versions patched into the training
    path."""
    return patched_kernels(fa.flash_attention_plain, ss.ssd_scan_plain,
                           bm.branch_matmul_plain)


def faulty_kernels(fa, ss, bm, scan_fault="diagonal"):
    """The three kernels, each with its planted fault, as wrappers that a
    model or a check calls in place of the sound ones.  ``scan_fault``:
    "diagonal" (y_t without its own token's term C_t.B_t dt_t x_t) or
    "restart" (every chunk from a zero state)."""
    def flash(q, k, v, causal=True, window=0):
        return fa.flash_attention(q, k, v, causal, window or FAULT_WINDOW)

    def scan(x, dt, A, B, C, chunk):
        if scan_fault == "diagonal":
            cb = (C * B).sum(-1).repeat_interleave(
                x.shape[2] // B.shape[2], dim=2)
            return ss.ssd_scan(x, dt, A, B, C, chunk) \
                - (cb * dt)[..., None] * x
        n = x.shape[0] * x.shape[1] // chunk      # one row a chunk

        def rows(t):
            return t.reshape(n, chunk, *t.shape[2:])
        return ss.ssd_scan(rows(x), rows(dt), A, rows(B), rows(C),
                           chunk).reshape(x.shape)

    def gemm(x, w, counts=None):
        short = (counts - 1).clamp(min=0) if counts is not None else \
            torch.full((x.shape[0],), max(x.shape[1] - 1, 0),
                       dtype=torch.int32, device=x.device)
        return bm.branch_matmul(x, w, short)
    return flash, scan, gemm


def fwd_bwd(fn, inputs, dout):
    """One forward and backward of ``fn`` on fresh leaves of ``inputs``."""
    def run():
        xs = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*xs), xs, dout)
    return run


def grad_case(name, label, fn, plain, faults, inputs, flush, bound, limit,
              library=None):
    """One differentiable kernel at one shape.  ``fn`` is its wrapper,
    ``plain`` the plain version and ``faults`` {label: the wrapper with a
    planted fault}, each with its other arguments bound, over the
    differentiable
    ``inputs``.  On the card: the wrapper's output carries the kernel's
    Function's graph, and its forward equals the wrapper's without a
    graph bit for bit; every gradient equals autograd's gradient of the
    plain version bit for bit (the Function's backward is that same
    computation); the output is within ``limit`` normwise of the plain
    version's, and no faulty wrapper's is.  Timed: the forward (no
    graph), and forward + backward of the wrapper, of the plain version
    and of ``library`` (one PyTorch call computing the same function, or
    None).  Returns (max abs err of the output against the plain
    version's, timing)."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(9)
    with torch.no_grad():
        want = fn(*inputs)
    xs = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    graph = type(out.grad_fn).__name__
    if graph != f"{FUNCTIONS[name]}Backward":
        raise AssertionError(f"{name}: the wrapper's output carries "
                             f"{graph}, not its Function's graph")
    dout = torch.randn(out.shape, generator=gen, device=out.device
                       ).to(out.dtype)
    grads = torch.autograd.grad(out, xs, dout)
    ys = [x.detach().requires_grad_(True) for x in inputs]
    pout = plain(*ys)
    pgrads = torch.autograd.grad(pout, ys, dout)
    torch.cuda.synchronize()
    identical(name, f"{label}: forward with the Function's graph vs "
              f"without a graph", out.detach(), want)
    for i, (g, p) in enumerate(zip(grads, pgrads)):
        identical(name, f"{label}: gradient of input {i} vs autograd of "
                  f"the plain version", g, p)
    pout = pout.detach()
    err = (out.detach().float() - pout.float()).abs().max().item()
    close = normwise(out.detach(), pout)
    with torch.no_grad():
        wrong = {k: normwise(f(*inputs), pout) for k, f in faults.items()}
    log(f"{name} {label}: output vs plain normwise {close:.3e} (limit "
        f"{limit}); planted faults read "
        + ", ".join(f"{k} {w:.3e}" for k, w in wrong.items()))
    if not close <= limit:
        raise AssertionError(f"{name} {label}: output off the plain "
                             f"version")
    if not min(wrong.values()) > limit:
        raise AssertionError(f"{name} {label}: the check passes a "
                             f"planted fault")
    del grads, pgrads, out, pout, xs, ys
    with torch.no_grad():
        fwd = median_ms(lambda: fn(*inputs), flush, GRAD_ITERS)
    t = dict(fwd_ms=fwd,
             ms=median_ms(fwd_bwd(fn, inputs, dout), flush, GRAD_ITERS),
             plain_ms=median_ms(fwd_bwd(plain, inputs, dout), flush,
                                GRAD_ITERS),
             library_ms=None if library is None else median_ms(
                 fwd_bwd(library, inputs, dout), flush, GRAD_ITERS),
             bound=bound)
    lib = "" if library is None else \
        f", library {t['library_ms']:.4f} ms"
    log(f"{name} {label}: forward {fwd:.4f} ms; forward + backward: "
        f"Function {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms{lib}, "
        f"bound {bound[0]:.5f} ms ({bound[1]}); output vs plain max abs "
        f"{err:.3e}")
    return err, t


def bound_of(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def grad_phase(fa, ss, bm, device):
    """Phase 23: the three kernels' ``autograd.Function``s at the training
    path's shapes: ``flash_attention`` bf16 at stablelm-3b's prefill
    shape and whisper-tiny's encoder and cross shapes (beside SDPA's
    forward + backward), ``ssd_scan`` fp32 at mamba2-370m's (no PyTorch
    call computes it), ``branch_matmul`` bf16 at dbrx's gate/up widths
    with a top-4 routing's counts over 512 tokens (beside ``torch.bmm``'s
    forward + backward, which computes every row).  Returns {row name:
    (max abs err, timing at the first shape)}."""
    from repro_torch.models.moe import dropless_capacity

    gen = torch.Generator(device=device).manual_seed(12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    bf16 = torch.bfloat16
    bad_flash, bad_scan, bad_gemm = faulty_kernels(fa, ss, bm)
    restart = faulty_kernels(fa, ss, bm, "restart")[1]
    rows, worst, first = {}, 0.0, None
    for label, B_, H_, K_, S_, T_, D_, causal in GRAD_FLASH:
        q = torch.randn((B_, H_, S_, D_), generator=gen, device=device
                        ).to(bf16)
        k, v = (torch.randn((B_, K_, T_, D_), generator=gen, device=device
                            ).to(bf16) for _ in range(2))
        # forward 4 D a pair, backward 8 (dV, dP, dQ, dK); q, k, v, dout
        # read, out, dq, dk, dv written
        pairs = flash_pairs(S_, T_, causal, 0) * B_ * H_
        bound = bound_of(4 * (q.numel() + k.numel()) * 2, 12 * D_ * pairs,
                         bf16)
        e, t = grad_case(
            "flash_attention", f"{label} bf16 B={B_} H={H_} K={K_} S={S_} "
            f"T={T_} D={D_} {'causal' if causal else 'non-causal'}",
            lambda q, k, v: fa.flash_attention(q, k, v, causal),
            lambda q, k, v: fa.flash_attention_plain(q, k, v, causal),
            {"window": lambda q, k, v: bad_flash(q, k, v, causal)},
            [q, k, v], flush, bound, GRAD_BF16_NORMWISE,
            lambda q, k, v: sdpa_flash(q, k, v, causal, 0))
        worst, first = max(worst, e), first or t
        del q, k, v
        torch.cuda.empty_cache()
    rows["flash_attention_grad"] = (worst, first)

    g = GRAD_SSD
    args = ssd_inputs(np.random.default_rng(13), g["b"], g["S"], g["H"],
                      g["G"], g["N"], device, False)
    from repro_torch.core.flops import ssd_scan_flops

    # the recurrence's operations, thrice (each product's backward is two
    # products); x, dt, A, B, C, dy read, y and each gradient written
    n_in = sum(t.numel() for t in args)
    bound = bound_of(4 * (2 * n_in + 2 * args[0].numel()),
                     3 * ssd_scan_flops(g["b"], g["S"], g["H"], SSD_P,
                                        g["N"]), torch.float32)
    L = g["L"]
    rows["ssd_scan_grad"] = grad_case(
        "ssd_scan", f"mamba2-370m fp32 b={g['b']} S={g['S']} H={g['H']} "
        f"P={SSD_P} N={g['N']} chunk {L}",
        lambda *a: ss.ssd_scan(*a, L), lambda *a: ss.ssd_scan_plain(*a, L),
        {"diagonal": lambda *a: bad_scan(*a, L),
         "restart": lambda *a: restart(*a, L)}, list(args), flush, bound,
        GRAD_FP32_NORMWISE)
    del args
    torch.cuda.empty_cache()

    g = GRAD_GEMM
    counts = routing_counts(gen, g["E"], g["k"], g["T"], device)
    cap = dropless_capacity(counts, g["T"])
    x = torch.randn((g["E"], cap, g["d"]), generator=gen, device=device
                    ).to(bf16)
    w = (torch.randn((g["E"], g["d"], g["f"]), generator=gen, device=device)
         / np.sqrt(g["d"])).to(bf16)
    routed, live = int(counts.sum()), int((counts > 0).sum())
    # forward and the two backward products on the routed rows; x, dx on
    # the routed rows, w and dw of the experts with a row, out and dout
    bound = bound_of(2 * (2 * routed * g["d"] + 2 * live * g["d"] * g["f"]
                          + 2 * g["E"] * cap * g["f"]),
                     3 * 2 * routed * g["d"] * g["f"], bf16)
    e, t = grad_case(
        "branch_matmul", f"dbrx gate/up bf16 E={g['E']} cap={cap} "
        f"d={g['d']} f={g['f']}, top-{g['k']} counts of {g['T']} tokens "
        f"({routed} rows)",
        lambda x, w: bm.branch_matmul(x, w, counts),
        lambda x, w: bm.branch_matmul_plain(x, w, counts),
        {"short": lambda x, w: bad_gemm(x, w, counts)}, [x, w], flush,
        bound,
        GRAD_BF16_NORMWISE, torch.bmm)
    xs = x.detach().requires_grad_(True)
    gx, = torch.autograd.grad(bm.branch_matmul(xs, w, counts), xs,
                              torch.ones((g["E"], cap, g["f"]), dtype=bf16,
                                         device=device))
    past = torch.arange(cap, device=device)[None, :] >= counts[:, None]
    if torch.count_nonzero(gx[past]):
        raise AssertionError("branch_matmul: rows past the counts got a "
                             "gradient")
    log("branch_matmul: rows past the counts get exactly zero gradient")
    rows["branch_matmul_grad"] = (e, t)
    del x, w, xs, gx, flush
    torch.cuda.empty_cache()
    return rows


def expected_train_launches(cfg):
    """Kernel launches one train step makes: every kernel of a layer
    twice (the forward and the remat recompute), Whisper's encoder once
    (no remat, as in JAX)."""
    from repro_torch.models.blocks import block_pattern
    from repro_torch.models.model import _moe_impl_for

    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.encoder_layers + 4 * cfg.num_layers,
                "ssd_scan": 0, "branch_matmul": 0}
    kinds = block_pattern(cfg)
    ragged = _moe_impl_for(cfg, False) == "ragged"
    return {"flash_attention": 2 * sum(m == "attn" for m, _ in kinds),
            "ssd_scan": 2 * sum(m == "mamba" for m, _ in kinds),
            "branch_matmul": 6 * sum(c == "moe" for _, c in kinds) * ragged}


def train_step_bound(params, tokens):
    """The least time of one train step: 6 operations per weight-matrix
    entry and token (forward 2, backward 4; attention scores left out),
    or the optimizer's bytes, 28 per parameter (master, m and v read and
    written in fp32, the gradient read and the parameter written in
    bf16, or their fp32 equivalents), whichever is larger."""
    named = dict(params.named_parameters())
    mats = sum(p.numel() for n, p in named.items()
               if p.ndim >= 2 and not (n == "embed" and "lm_head" in named))
    n = sum(p.numel() for p in named.values())
    return bound_of(28 * n, 6 * mats * tokens, torch.bfloat16)


def step_one(api, params, batch):
    """Loss, gradient norm and gradients of one train step's batch."""
    from repro_torch.training import loss_and_grads
    from repro_torch.training.optimizer import global_norm

    loss, _, grads = loss_and_grads(api, params, batch)
    return loss, global_norm(grads), grads


def rel(a, b):
    """|a - b| / |b| of two device scalars."""
    return abs(a.item() - b.item()) / abs(b.item())


def worst_leaf(grads, want):
    """The largest normwise difference of a leaf's gradient from
    ``want``'s, over the leaves whose ``want`` is not zero."""
    return max(normwise(grads[n], g) for n, g in want.items()
               if torch.count_nonzero(g))


def first_step_check(api, params, batch, fa, ss, bm, want, label):
    """Step 1's loss and gradient norm through the kernels (their launches
    counted) against the same with the plain versions patched in,
    relative within TRAIN_TOL and the worst leaf's gradient normwise
    within LEAF_TOL, and the same step with the planted faults patched
    in (``faulty_kernels``) outside one of them; a scan path also reads
    the restart fault (see FAULT_WINDOW).  Returns the kernels' loss."""
    mods = (fa, ss, bm)
    for m in mods:
        m.reset_launches()
    loss, gnorm, grads = step_one(api, params, batch)
    torch.cuda.synchronize()
    launched = kernel_counts(mods)
    with plain_kernels(fa, ss, bm):
        ploss, pnorm, pgrads = step_one(api, params, batch)
    torch.cuda.synchronize()
    if kernel_counts(mods) != launched:
        raise AssertionError(f"{label}: a kernel launched with the plain "
                             f"versions patched in")
    leaf = worst_leaf(grads, pgrads)
    del grads
    with patched_kernels(*faulty_kernels(fa, ss, bm)):
        floss, fnorm, fgrads = step_one(api, params, batch)
    fleaf = worst_leaf(fgrads, pgrads)
    del fgrads
    restart = ""
    if want["ssd_scan"]:
        with patched_kernels(*faulty_kernels(fa, ss, bm, "restart")):
            rloss, rnorm, rgrads = step_one(api, params, batch)
        restart = (f"; the scan restarting every chunk: relative "
                   f"{rel(rloss, ploss):.3e} and {rel(rnorm, pnorm):.3e}, "
                   f"worst leaf {worst_leaf(rgrads, pgrads):.3e}")
        del rgrads
    del pgrads
    rel_l, rel_g = rel(loss, ploss), rel(gnorm, pnorm)
    frel_l, frel_g = rel(floss, ploss), rel(fnorm, pnorm)
    log(f"train {label}: step 1 through the kernels: loss {loss.item():.6f},"
        f" grad_norm {gnorm.item():.6f}, launches {launched}; plain "
        f"versions: loss {ploss.item():.6f}, grad_norm {pnorm.item():.6f}; "
        f"relative {rel_l:.3e} and {rel_g:.3e} (tol {TRAIN_TOL}), worst "
        f"leaf gradient normwise {leaf:.3e} (tol {LEAF_TOL}); planted "
        f"faults: relative "
        f"{frel_l:.3e} and {frel_g:.3e}, worst leaf {fleaf:.3e}{restart}")
    if launched != want:
        raise AssertionError(f"{label}: launches {launched}, expected {want}")
    if not (torch.isfinite(loss) and torch.isfinite(gnorm)):
        raise AssertionError(f"{label}: step 1 is not finite")
    if not (rel_l <= TRAIN_TOL and rel_g <= TRAIN_TOL and leaf <= LEAF_TOL):
        raise AssertionError(f"{label}: step 1 off its plain versions")
    if not (max(frel_l, frel_g) > TRAIN_TOL or fleaf > LEAF_TOL):
        raise AssertionError(f"{label}: the check passes the planted "
                             f"faults")
    return loss


def train_run(label, run, want, mods, first_loss, tokens,
              n_steps=TRAIN_STEPS):
    """``run(on_step)`` trains ``n_steps`` steps; every step must launch
    ``want`` and give a finite loss and grad_norm, and step 1's loss must
    equal ``first_loss`` bit for bit.  Logs ms a step, tokens/s and peak
    memory; returns the launches of the whole run."""
    steps = []
    for m in mods:
        m.reset_launches()
    before = [kernel_counts(mods)]

    def record(step, params, opt_state, metrics):
        now = kernel_counts(mods)
        steps.append((metrics, {k: now[k] - before[0][k] for k in now}))
        before[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run(record)
    total = kernel_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    secs = [m["seconds"] for m, _ in steps[1:]]
    ms = float(np.median(secs)) * 1e3
    log(f"train {label}: {len(steps)} steps, losses "
        f"{[round(m['loss'], 4) for m, _ in steps]}, grad_norms "
        f"{[round(m['grad_norm'], 4) for m, _ in steps]}; launches a step "
        f"{steps[0][1]}; {ms:.1f} ms a step (median of steps 2-"
        f"{len(steps)}, {min(secs) * 1e3:.1f}-{max(secs) * 1e3:.1f}; step 1 "
        f"{steps[0][0]['seconds'] * 1e3:.1f} ms), {tokens / ms * 1e3:.0f} "
        f"tokens/s, peak device memory {peak / 2**30:.2f} GiB")
    if len(steps) != n_steps:
        raise AssertionError(f"{label}: {len(steps)} steps")
    for i, (m, launched) in enumerate(steps):
        if launched != want:
            raise AssertionError(f"{label}: step {i + 1} launched "
                                 f"{launched}, expected {want}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{label}: step {i + 1} is not finite")
    if steps[0][0]["loss"] != first_loss:
        raise AssertionError(f"{label}: step 1's loss {steps[0][0]['loss']}"
                             f" differs from the checked {first_loss}")
    log(f"train {label}: step 1's loss bit-identical to the checked step")
    return total


def free():
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(arch, B_, S_, fa, ss, bm, device):
    """Phases 24-26: ``arch`` at full width (bf16, random weights from
    seed 0), ``SyntheticTokens(seed=0)`` batches of B_ x S_ (whisper:
    ``cfg.encoder_seq`` stub frames beside), AdamW on fp32 masters at
    lr TRAIN_LR.  Step 1 against the plain versions (first_step_check),
    a profile of one train step, then ``launch.train.train(...,
    reduced=False)`` for TRAIN_STEPS steps.  Returns the launches of the
    ``train`` run."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.launch.train import train
    from repro_torch.models import build_model, stub_audio_frontend
    from repro_torch.training import OptConfig, init_opt_state
    from repro_torch.training import make_train_step

    cfg = get_config(arch)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init(gen)
    # train()'s first batch: the stream's first, frames drawn after init
    batch = to_device(next(SyntheticTokens(cfg.vocab_size, S_, B_, seed=0)),
                      device)
    if cfg.is_encoder_decoder:
        batch["frames"] = stub_audio_frontend(gen, cfg, B_, cfg.encoder_seq)
    n = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    label = f"{arch} B={B_} S={S_}"
    log(f"train {label}: full width, {n / 1e9:.3f} B params in {api.dtype}"
        f", init {time.perf_counter() - t0:.1f} s")
    want = expected_train_launches(cfg)
    first = first_step_check(api, params, batch, fa, ss, bm, want, label)
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 5
                                                      + 1))
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(api, opt_cfg)
    tokens = B_ * S_
    device_profile(f"{label} train step", lambda: step(params, state, batch),
                   1, train_step_bound(params, tokens),
                   tuple((k, m.launches) for k, m in
                         (("flash_attention", fa), ("ssd_scan", ss),
                          ("branch_matmul", bm)) if want[k]), grad=True)
    del api, params, state, step, batch
    free()
    total = train_run(
        label, lambda record: train(arch, steps=TRAIN_STEPS, batch=B_,
                                    seq=S_, reduced=False, lr=TRAIN_LR,
                                    log_every=TRAIN_STEPS, device=device,
                                    on_step=record),
        want, (fa, ss, bm), first.item(), tokens)
    free()
    return total


def moe_train_phase(fa, ss, bm, device):
    """The MoE expert GEMMs in training: the kimi-like config of the
    tests (``kimi-k2-1t-a32b.reduced()`` with 8 experts, ``layer_offset
    =1``: a dense layer, then ``moe_ragged`` with the shared expert) in
    bf16, so the expert GEMMs take the tensor-core path.  No full-width
    MoE model trains on one card: dbrx-132b cut to one layer is 4.49 B
    parameters (``ModelConfig.param_count``), 71.9 GB at 16 bytes a
    parameter (bf16 weight and gradient, fp32 master, m and v) before
    any activation.  Step 1 against the plain versions, then
    TRAIN_STEPS steps of ``make_train_step``.  Returns the run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_opt_state
    from repro_torch.training import make_train_step

    cfg = get_config("kimi-k2-1t-a32b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, num_experts=8, layer_offset=1))
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    B_, S_ = 8, 64
    data = SyntheticTokens(cfg.vocab_size, S_, B_, seed=0)
    batches = [to_device(next(data), device) for _ in range(TRAIN_STEPS)]
    label = f"kimi-like reduced bf16 B={B_} S={S_}"
    want = expected_train_launches(cfg)
    first = first_step_check(api, params, batches[0], fa, ss, bm, want,
                             label)
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=2)
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(api, opt_cfg)

    def run(record):
        nonlocal params, state
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            params, state, m = step(params, state, batch)
            m = {k: float(v) for k, v in m.items()}
            m["seconds"] = time.perf_counter() - t1
            record(i, params, state, m)

    total = train_run(label, run, want, (fa, ss, bm), first.item(), B_ * S_)
    del api, params, state, step
    free()
    return total


def learning_phase():
    """Phase 27: ``examples/torch_train_small.py`` on the card: reduced
    stablelm-3b, LEARN_STEPS steps, the loss below 0.7x its first value,
    then its checkpoint restored bit for bit (the example raises
    otherwise)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_train_small", os.path.join(HERE, "examples",
                                          "torch_train_small.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    losses = example.main([str(LEARN_STEPS)])
    log(f"learn: examples/torch_train_small.py {LEARN_STEPS} steps on the "
        f"card in {time.perf_counter() - t0:.1f} s: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, checkpoint round trip bit for bit")
    free()


def training_phases(fa, ss, bm, device):
    """Phases 23-27.  Returns ({row name: (err, timing)}, {row name:
    launches in its training run}) for the kernels line's gradient
    rows."""
    rows = grad_phase(fa, ss, bm, device)
    runs = {arch: train_phase(arch, B_, S_, fa, ss, bm, device)
            for arch, B_, S_ in TRAIN_RUNS}
    runs["moe"] = moe_train_phase(fa, ss, bm, device)
    from repro_torch.launch.train import main as train_main

    argv = ["--arch", "stablelm-3b", "--full", "--steps", "3"]
    log(f"cli: python -m repro_torch.launch.train {' '.join(argv)}")
    losses = train_main(argv)
    if not all(np.isfinite(losses)):
        raise AssertionError("the train CLI gave a loss that is not finite")
    free()
    learning_phase()
    launches = {"flash_attention_grad":
                runs["stablelm-3b"]["flash_attention"],
                "ssd_scan_grad": runs["mamba2-370m"]["ssd_scan"],
                "branch_matmul_grad": runs["moe"]["branch_matmul"]}
    log(f"train: kernel launches in the training runs {runs}")
    return rows, launches


def count_calls(api):
    """Wrap ``api.decode_fn`` with a call counter; returns the counter."""
    calls = [0]
    decode_fn = api.decode_fn

    def counted(*args, **kwargs):
        calls[0] += 1
        return decode_fn(*args, **kwargs)

    api.decode_fn = counted
    return calls


def main() -> int:
    if sys.argv[1:2] == ["--dryrun"]:
        return dryrun_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from repro_torch.configs import get_config
    from repro_torch.device import deterministic
    from repro_torch.kernels import _build
    from repro_torch.kernels import branch_matmul as bm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import build_model

    deterministic()
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    log(f"build: {_build.build():.2f} s for {', '.join(KERNELS)}")
    err, timing = kernel_phase(pa, device)
    err["branch_matmul"], timing["branch_matmul"] = branch_phase(bm, device)
    e2, t2 = attention_phase(pa, da, fa, device)
    err.update(e2)
    timing.update(t2)
    for name, e in whisper_kernel_phase(da, fa, device).items():
        err[name] = max(err[name], e)
    err["ssd_scan"], timing["ssd_scan"] = ssd_phase(ss, device)

    # phase 4: the main path at full width
    cfg = get_config("stablelm-3b")
    t0 = time.perf_counter()
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params in {api.dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")
    main_launches, _ = serve_phase(api, params, pa, da)
    main_launches["flash_attention"] = prefill_phase(
        api, params, prefill_tokens(cfg, device), "flash_attention",
        (FLASH_MODULE, "flash_attention", fa.flash_attention_plain),
        XCHECK_PROMPT, device)
    step_profile(api, params, device, (
        ("paged_decode_attention", pa.launches),
        ("decode_attention", da.launches)))
    del api, params
    gc.collect()
    torch.cuda.empty_cache()

    reference_phase(device)

    from repro_torch.launch.serve import serve
    done = serve("stablelm-3b", engine_mode="continuous")
    if not all(c.ok for c in done.values()):
        raise AssertionError("CLI serve did not complete every request")
    log(f"cli: serve('stablelm-3b', engine_mode='continuous') completed "
        f"{len(done)} requests on {torch.cuda.get_device_name(0)}")
    from repro_torch.launch.serve import main as serve_main
    for argv in (["--engine", "round"], ["--no-paged"]):
        log(f"cli: python -m repro_torch.launch.serve {' '.join(argv)} "
            f"--requests 4 --max-new 8")
        serve_main(argv + ["--requests", "4", "--max-new", "8"])

    gc.collect()                   # the CLI's model, before the planner
    torch.cuda.empty_cache()
    planner_kernel_path(bm, device)
    h100_profile_phase(device)
    hetero_zoo_phase(bm, device)
    planner_model_dag(device)
    main_launches["ssd_scan"] = mamba_phases(ss, count_calls, device)
    gc.collect()
    torch.cuda.empty_cache()
    e_moe, timing["branch_matmul"] = moe_kernel_phase(bm, device)
    main_launches["branch_matmul"], e_prefill = moe_phases(bm, pa, da, fa,
                                                           device)
    err["branch_matmul"] = max(err["branch_matmul"], e_moe, e_prefill)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_launches = whisper_phases(da, fa, device, (pa, bm, ss))
    gc.collect()
    torch.cuda.empty_cache()
    qwen_rows, qwen_err, qwen_launches = qwen_phases(pa, da, fa, ss, bm,
                                                     device)
    for name, e in qwen_err.items():
        err[name] = max(err[name], e)
    for row, t in qwen_rows.items():
        log(f"qwen2-vl kernel row {row}: {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t.get('library_ms')}, bound "
            f"{t['bound'][0]:.6f} ms ({t['bound'][1]})")
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches, dist_err = distributed_phases(fa, bm, device)
    err["branch_matmul"] = max(err["branch_matmul"], dist_err)
    grad_rows, grad_launches = training_phases(fa, ss, bm, device)

    rows = []
    for name, meta in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"],
                     "launches": main_launches[name],
                     "max_abs_err": err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "library_ms": t.get("library_ms")})
    for name, (e, t) in grad_rows.items():
        meta = KERNELS[name[:-len("_grad")]]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"],
                     "launches": grad_launches[name], "max_abs_err": e,
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"], "fwd_ms": t["fwd_ms"]})
    print("whisper launches per call: " + json.dumps(whisper_launches))
    print("qwen2-vl launches per call: " + json.dumps(qwen_launches))
    print("distributed launches per call: " + json.dumps(dist_launches))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
