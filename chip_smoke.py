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
   (tolerance fp32 2e-5, bf16 2e-2; pools after the append bit-exact),
   each decode case also bit-identical through a table of 256 blocks, one
   row alone and on a second launch, then a long context (T=4096) and
   h2o-danube's GQA window case (T=8192), every row full, timed beside the
   bound at the three shapes; ``branch_matmul`` against its plain version
   at the planner path's two sites (G=6, M=512, K=2560, N=240 and G=6,
   M=512, K=80, N=2560) in fp32 and bf16, and a ragged
   ``parallel_branches`` case (same tolerances; two launches
   bit-identical; per fp32 site, whether the kernel equals ``torch.bmm``
   bit for bit); median times by CUDA events beside the bound and, for
   ``branch_matmul``, ``torch.bmm``; ``decode_attention`` on the model's
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
   the mean of V over all T keys), each launched twice and bit-identical —
   times beside their bounds and one ``scaled_dot_product_attention`` call
   each; ``ssd_scan`` (fp32) against its plain version and the sequential
   recurrence at rtol = atol = 2e-4 at the prefill shape (b=2, H=32,
   S=2048, chunk 256, P=64, N=128), a long prompt (b=1, S=8192) and an odd
   chunk with groups broadcast by stride (S = L = 100, G=2, strided
   operands), times beside the bound (no PyTorch call computes the scan);
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
   and 1 (streams bit-identical to the paged run) and through the round
   engine ``ServingEngine`` (streams compared; a divergence is printed
   with the logits at its first step), each run with its launch counts
   zeroed just before and read just after: 32 ``decode_attention``
   launches per ``decode_fn`` call, none of the paged kernels; then
   ``prefill_fn`` on B=2, S=2048: 32 ``flash_attention`` launches per
   call, logits within a normwise 2e-2 of the same call with the plain
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
   full width, depth cut to 16 of its 32 layers (the Mamba2 phases took
   the time; fp32 weights from ``torch.Generator`` seed 0), batch 1, seq
   256, through the planner and every mode; fused and whole-plan logits
   bit-identical to ``reference``;
10. mamba2 prefill: ``mamba2-370m`` at full width (48 Mamba2 layers,
    d_model 1024, d_state 128, bf16, random weights from
    ``torch.Generator`` seed 0), ``prefill_fn`` on B=2, S=2048: 48
    ``ssd_scan`` launches per call, logits against the same call with
    the plain scan patched in — at 2e-4 in an fp32 model with the same
    weights, and in bf16 at 4e-2 (this bf16 model moves its logits
    more than 2e-2 between two fp32 orders of the same scan: the plain
    version at chunk 128 against 256 is printed beside, and so are
    deliberately perturbed scans), the cross-checks of phase 5 on a
    256-token prompt, the scan at layer 0's own inputs against the
    float64 recurrence, and profiles of one decode step and one prefill
    call;
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
    round``.

The last two lines are the ``kernels`` JSON object and the result
object ``{"ok": true, "device": {...}}``.  Without a card, or without
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

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
B, H, D, BS = 8, 32, 80, 16        # the full-width main path's shapes
PROMPT_MIN, PROMPT_MAX, MAX_NEW, PREFIX = 16, 128, 32, 32
MAX_CONTEXT = PROMPT_MAX + MAX_NEW
BPR = -(-MAX_CONTEXT // BS)        # blocks per row at that context
SPIN_CYCLES = 2_000_000            # ~1 ms: covers one wrapper's host time

BM_SITES = {"qkv": (6, 512, 2560, 240), "out": (6, 512, 80, 2560)}
PLANNER_GRAPH = dict(dim=2560, heads=32, seq=512)
DAG_BATCH, DAG_SEQ = 1, 256
DAG_LAYERS = 16                    # planner B's stablelm-3b depth (of 32)
RUNS_A, RUNS_B = 15, 3             # timed runs per planner mode
MODES = {                          # PlanExecutor keyword arguments
    "reference": dict(mode="reference"),
    "sequential": dict(mode="sequential"),
    "interpreted": dict(fused=False),
    "fused": dict(),
    "whole_plan": dict(whole_plan=True),
    "fused, kernel off": dict(use_branch_kernel=False),
}

# the dense-cache and prefill phases (slice 3)
DA_LONG_T = 4096                   # decode_attention at a long context
DANUBE = dict(H=32, K=8, D=120, window=4096)   # h2o-danube-3-4b widths
FA_B, FA_S = 2, 2048               # flash_attention at the prefill shape
FA_WINDOW_S = 6144                 # h2o-danube window case, B=1
FA_CROSS = dict(B=2, S=448, T=1500)            # causal=False, T > S
FA_OFF_TILE = dict(S=1000, K=8)    # S = T off the 64-row tile, GQA 32/8
FA_EMPTY = dict(S=32, T=8, window=4)           # rows 11.. have no valid key
PREFILL_B, PREFILL_S, PREFILL_RUNS = 2, 2048, 5
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
SSD_CASES = (                      # label, b, S, H, G, L, strided
    ("prefill shape", PREFILL_B, PREFILL_S, 32, 1, 256, False),
    ("long prompt", 1, 8192, 32, 1, 256, False),
    ("odd L = S, G=2", 2, 100, 32, 2, 100, True),
)
MAMBA_XCHECK = 256                 # one chunk: prefill_fn needs S % 256
MAMBA_RUNS = 3                     # timed runs per planner mode

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


def append_case(rng, dtype, device):
    nb = B * BPR
    K = H
    pool = (nb + 1, BS, K, D)
    k_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    v_pool = torch.tensor(rng.standard_normal(pool), dtype=dtype,
                          device=device)
    k_new = torch.tensor(rng.standard_normal((B, 1, K, D)), dtype=dtype,
                         device=device)
    v_new = torch.tensor(rng.standard_normal((B, 1, K, D)), dtype=dtype,
                         device=device)
    tables = torch.tensor(rng.permutation(nb).reshape(B, BPR)
                          .astype(np.int32), device=device)
    lens = torch.tensor(rng.integers(0, BPR * BS, B).astype(np.int32),
                        device=device)
    n_valid = torch.ones(B, dtype=torch.int32, device=device)
    n_valid[3] = 0                                  # an idle row: scratch
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
        k1, v1, kn, vn, tables, lens, nv = append_case(rng, dtype, device)
        k2, v2 = k1.clone(), v1.clone()
        pa.paged_append(k1, v1, kn, vn, tables, lens, nv)
        pa.paged_append_plain(k2, v2, kn, vn, tables, lens, nv)
        torch.cuda.synchronize()
        exact = torch.equal(k1, k2) and torch.equal(v1, v2)
        log(f"paged_append {str(dtype)[6:]} B={B} K={H} D={D}: pools "
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


def time_case(name, label, kernel, plain, library, bound, flush):
    t = dict(ms=median_ms(kernel, flush), plain_ms=median_ms(plain, flush),
             library_ms=median_ms(library, flush), bound=bound)
    log(f"{name} {label}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
        f"{bound[0]:.5f} ms ({bound[1]})")
    return t


def attention_phase(pa, da, fa, device):
    """Returns ({name: max abs err}, {name: timing at the main-path
    shape}) for decode_attention and flash_attention."""
    rng = np.random.default_rng(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    err = {"decode_attention": 0.0, "flash_attention": 0.0}
    timing, extra = {}, {}

    def dec(label, q, k, v, pos, lens, window, tile=BS, timed=None):
        got = da.decode_attention(q, k, v, pos, lens, window=window,
                                  tile=tile)
        want = da.decode_attention_plain(q, k, v, pos, lens, window)
        torch.cuda.synchronize()
        err["decode_attention"] = max(err["decode_attention"], check(
            "decode_attention", label, got, want, q.dtype))
        if timed is not None:
            timed[label] = time_case(
                "decode_attention", label,
                lambda: da.decode_attention(q, k, v, pos, lens,
                                            window=window, tile=tile),
                lambda: da.decode_attention_plain(q, k, v, pos, lens,
                                                  window),
                lambda: sdpa_decode(q, k, v, pos, lens, window),
                dense_decode_bound(q, k, pos, lens, window), flush)
        return got

    T = MAX_CONTEXT
    arange = torch.arange(T, dtype=torch.int32, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, lens = dense_decode_case(rng, B, H, H, D, T, dtype, device)
        got = dec(f"B={B} H=K={H} D={D} T={T} ragged", q, k, v, arange,
                  lens, 0)
        # the paged kernel on the same K/V laid into a block pool
        tables = torch.randperm(B * BPR, device=device).reshape(B, BPR).int()
        pools = []
        for c in (k, v):
            pool = torch.zeros(B * BPR + 1, BS, H, D, dtype=dtype,
                               device=device)
            pool[tables.long().reshape(-1)] = c.transpose(1, 2).reshape(
                B * BPR, BS, H, D)
            pools.append(pool)
        dt = str(dtype)[6:]
        # the same rows over a cache of DA_LONG_T slots: empty past
        # cache_len, as the round engine's wider rounds give
        wide = [torch.cat([c.transpose(1, 2), torch.randn(
                    B, DA_LONG_T - T, H, D, dtype=dtype, device=device)],
                          1).transpose(1, 2) for c in (k, v)]
        wide_pos = torch.arange(DA_LONG_T, dtype=torch.int32, device=device)
        for window in (0, 37):
            tag = f"{dt} window={window}"
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
            for b in (0, 3, B - 1):
                one = da.decode_attention(q[b:b + 1], k[b:b + 1],
                                          v[b:b + 1], arange, lens[b:b + 1],
                                          window=window, tile=BS)
                identical("decode_attention", f"{tag}, row {b} alone vs in "
                          f"the batch of {B}", one[0], got[b])
        del wide
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

    def flash(label, B_, H_, K, S, T_, D_, causal, window, dtype,
              timed=None):
        q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device=device)
                   for shape in ((B_, H_, S, D_), (B_, K, T_, D_),
                                 (B_, K, T_, D_)))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        err["flash_attention"] = max(err["flash_attention"], check(
            "flash_attention", label, got, want, dtype))
        same = torch.equal(got, again)
        log(f"flash_attention {label} {str(dtype)[6:]}: reruns "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("flash_attention differs from itself")
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
        del want, again
        if timed is not None:
            timed[label] = time_case(
                "flash_attention", label,
                lambda: fa.flash_attention(q, k, v, causal=causal,
                                           window=window),
                lambda: fa.flash_attention_plain(q, k, v, causal, window),
                lambda: sdpa_flash(q, k, v, causal, window),
                flash_bound(q, k, causal, window), flush)

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
    return err, timing


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


def dense_serve_phase(api, params, calls, paged_streams, pa, da):
    """Phase 5b: the paged run's workload through ContinuousEngine(paged=
    False) at megastep 8 and 1 and through ServingEngine.  Each run
    zeroes the launch counts just before and reads them just after;
    returns the decode_attention launches of the three runs."""
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
        if label.startswith("continuous"):
            raise AssertionError(f"{label}: streams differ from the paged "
                                 f"run")
    return total


def normwise(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def prefill_phase(api, params, kern, name, patch, xcheck, device,
                  tol=PREFILL_TOL, readings=()):
    """Phase 5c (and 10 for mamba2): prefill_fn at B=2, S=2048 through
    the kernel ``name`` of package ``kern``, held to the same call with
    the plain version patched in (``patch``: module, attribute, plain
    function) — in the bf16 model at ``PREFILL_TOL`` and in an fp32
    model with the same weights at ``PREFILL_TOL_FP32`` — and to the
    token-by-token path on an ``xcheck``-token prompt.

    ``tol`` is the bf16 limit; ``readings`` = ((label, function), ...):
    variants of the plain version whose distance from it is printed
    beside, to show where the limit lies.  Returns the launches of one
    prefill_fn call."""
    import importlib

    from repro_torch.runtime.sampling import greedy_serving
    from repro_torch.runtime.stepper import Stepper

    cfg = api.cfg
    rng = np.random.default_rng(3)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (PREFILL_B, PREFILL_S)),
                          dtype=torch.int32, device=device)
    batch = {"tokens": tokens}
    with torch.no_grad():
        api.prefill_fn(params, batch)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_launches()
        logits = api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        launched = kern.launches[name]
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(PREFILL_RUNS):
            t0 = time.perf_counter()
            api.prefill_fn(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (PREFILL_B, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError("prefill_fn: malformed logits")
        if launched != cfg.num_layers:
            raise AssertionError(f"prefill_fn: {launched} {name} "
                                 f"launches, expected {cfg.num_layers}")
        mod_name, attr, plain_fn = patch
        mod = importlib.import_module(mod_name)
        kernel = getattr(mod, attr)

        def patched(api_, params_, fn):
            setattr(mod, attr, fn)
            try:
                return api_.prefill_fn(params_, batch)
            finally:
                setattr(mod, attr, kernel)

        plain = patched(api, params, plain_fn)
        note = "".join(
            f"; {label} {normwise(patched(api, params, fn), plain):.3e}"
            for label, fn in readings)
        torch.cuda.synchronize()
    rel = normwise(logits, plain)
    same_argmax = torch.equal(greedy_serving(logits), greedy_serving(plain))
    log(f"prefill: {cfg.name} prefill_fn B={PREFILL_B} S={PREFILL_S} at "
        f"full width: {launched} {name} launches per call, "
        f"{float(np.median(walls)):.3f} ms per call (median of "
        f"{PREFILL_RUNS}, {min(walls):.3f}-{max(walls):.3f}), peak device "
        f"memory {peak / 2**30:.2f} GiB; vs the plain version: max abs "
        f"{(logits.float() - plain.float()).abs().max().item():.3e} on "
        f"|logits| <= {plain.float().abs().max().item():.2f}, normwise "
        f"{rel:.3e} (tol {tol:.3e}), argmax "
        f"{'equal' if same_argmax else 'DIFFERS'}")
    if readings:
        log(f"prefill: variants of the plain version, normwise from "
            f"it{note}")
    if not rel <= tol:
        raise AssertionError(f"prefill_fn off its plain-{name} version")
    # an fp32 model with the same weights: kernel against plain version
    # without bf16 rounding, and how far each bf16 path lies from it (the
    # kernel should add no more error than the plain version)
    from repro_torch.models import build_model

    api32 = build_model(cfg, device=device, dtype="float32")
    p32 = api32.init(None)
    p32.load_state_dict(params.state_dict())
    prompt = tokens[:1, :xcheck]
    with torch.no_grad():
        ref32 = api32.prefill_fn(p32, batch)
        plain32 = patched(api32, p32, plain_fn)
        # the fp32 cross-check: prefill_fn against scalar token-by-token
        # decode on the dense cache, raw fp32 argmax (no bf16 ties)
        full32 = api32.prefill_fn(p32, {"tokens": prompt})
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
        full = api.prefill_fn(params, {"tokens": prompt})
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
    return launched


KERNEL_FAMILIES = (                # (substring of the kernel name, family)
    ("paged_decode", "paged_decode_attention"),
    ("dense_decode", "decode_attention"),   # the splits merge inside it
    ("paged_append", "paged_append"),
    ("ssd_scan", "ssd_scan"),
)


def device_profile(label, fn, n, bound, wrappers=()):
    """Where one call of ``fn`` spends its time: host+device wall time by
    the host clock, and the card's busy time by ``torch.profiler`` (the
    sum of its kernels, which run in order on one stream), split by
    kernel family.  ``bound`` = (ms, what) bounds the call from below.
    ``wrappers``: (family, launches dict) pairs; the dict's count under
    the family's name (its wrapper calls in the profiled window) is set
    beside the family's device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
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
        f"({launches / n:.0f} kernels), idle share {1 - busy / wall:.3f}, "
        f"{bound[1]} bound {bound[0]:.3f} ms")
    for family, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"step:   {family}: {ms:.3f} ms ({ms / busy:.1%} of busy)")


def step_profile(api, params, device, wrappers=()):
    """One full-width ``decode_fn`` call (B=8, every row at position 100)
    through :func:`device_profile`, on the paged pool and, for a model
    that attends, on the dense cache (MAX_CONTEXT slots a row); the
    weight bytes over the memory rate bound the step from below."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    bound = (weight_bytes / HBM_BYTES_PER_S * 1e3, "weight-read")
    if api.cfg.num_heads:
        dense = api.init_caches(B, MAX_CONTEXT, tile=BS)
        at100 = {"tokens": torch.zeros(B, 1, dtype=torch.int32,
                                       device=device),
                 "cache_len": torch.full((B,), 100, dtype=torch.int32,
                                         device=device)}
        device_profile(f"full-width {api.cfg.name} dense decode_fn (B=8, "
                       f"position 100, {MAX_CONTEXT} slots)",
                       lambda: api.decode_fn(params, dense, at100), 5,
                       bound, wrappers)
        del dense
    caches = api.init_paged_caches(B, B * BPR, BS)
    batch = {"tokens": torch.zeros(B, 1, dtype=torch.int32, device=device),
             "cache_len": torch.full((B,), 100, dtype=torch.int32,
                                     device=device),
             "active": torch.ones(B, dtype=torch.bool, device=device),
             "block_tables": torch.arange(B * BPR, dtype=torch.int32,
                                          device=device).reshape(B, BPR)}
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


def branch_phase(bm, device):
    """Both planner sites in fp32 and bf16, and a ragged group; returns
    (max abs err, timing summed over the two fp32 sites of one fused
    run)."""
    rng = np.random.default_rng(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst = 0.0
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=0.0)
    by = set()
    for site, (G, M, K, N) in BM_SITES.items():
        # outputs of std 0.5 stay below 4, where a bf16 ulp (1.6e-2) is
        # under the tolerance: two fp32 sums may round to adjacent values
        x0 = rng.standard_normal((G, M, K), dtype=np.float32)
        w0 = rng.standard_normal((G, K, N), dtype=np.float32) \
            / np.float32(2 * np.sqrt(K))
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(x0, device=device).to(dtype)
            w = torch.tensor(w0, device=device).to(dtype)
            got = bm.branch_matmul(x, w)
            again = bm.branch_matmul(x, w)
            want = bm.branch_matmul_plain(x, w)
            as_bmm = torch.equal(got, torch.bmm(x, w))
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, again)
            worst = max(worst, e)
            ms = median_ms(lambda: bm.branch_matmul(x, w), flush)
            plain_ms = median_ms(lambda: bm.branch_matmul_plain(x, w), flush)
            lib_ms = median_ms(lambda: torch.bmm(x, w), flush)
            bound, bound_by = gemm_bound(G, M, K, N, dtype)
            log(f"branch_matmul {site} {str(dtype)[6:]} G={G} M={M} K={K} "
                f"N={N}: max abs err {e:.3e} (tol {TOL[dtype]}), reruns "
                f"{'bit-identical' if same else 'DIFFER'}, "
                f"{'bit-identical to' if as_bmm else 'differs from'} "
                f"torch.bmm; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
            if not (e <= TOL[dtype] and same):
                raise AssertionError("branch_matmul disagrees with its plain "
                                     "version or with itself")
            if dtype == torch.float32:
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["library_ms"] += lib_ms
                total["bound"] += bound
                by.add(bound_by)
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
    total["bound"] = (total["bound"], "/".join(sorted(by)))
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


def planner_model_dag(device):
    """Phase 9: stablelm-3b at full width, ``DAG_LAYERS`` deep, through
    the planner."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ArenaExecutor, ParallaxConfig,
                                  clear_compile_cache, compile_plan,
                                  compile_schedule)
    from repro_torch.core.executor import to_device
    from repro_torch.models import build_model
    from repro_torch.models.dag_export import export_decoder_graph

    cfg = dataclasses.replace(get_config("stablelm-3b"),
                              num_layers=DAG_LAYERS)
    t0 = time.perf_counter()
    api = build_model(cfg, device=device, dtype="float32")
    lm = api.init(torch.Generator(device=device).manual_seed(0))
    g, make = export_decoder_graph(cfg, lm, DAG_BATCH, DAG_SEQ)
    export_s = time.perf_counter() - t0
    budget = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    plan = compile_plan(g, ParallaxConfig(budget=budget))
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = compile_schedule(plan, donate=True).stats
    lower_s = time.perf_counter() - t0
    log(f"planner B: {cfg.name} full width, {cfg.num_layers} of 32 "
        f"layers (d_model {cfg.d_model}, fp32), batch {DAG_BATCH}, seq "
        f"{DAG_SEQ}: {g.num_nodes()} nodes after build+export in "
        f"{export_s:.1f} s; planned in {plan_s:.2f} s (budget "
        f"{budget / 2**30:.2f} GiB) into {len(plan.branches)} branches, "
        f"{len(plan.layers)} layers, {len(plan.schedule.layers)} scheduled "
        f"layers, max width {plan.schedule.max_width()}; lowered in "
        f"{lower_s:.2f} s, {stats}")
    env = to_device(make(np.random.default_rng(0)), device)
    modes = {k: v for k, v in MODES.items() if k != "fused, kernel off"}
    res = run_modes(plan, env, device, modes, RUNS_B)
    ref = res["reference"][0]
    if ref.shape != (DAG_BATCH, DAG_SEQ, cfg.vocab_size) \
            or not torch.isfinite(ref).all():
        raise AssertionError("malformed logits")
    for mode, (o, disp, syncs, ms, peak) in res.items():
        same = torch.equal(o, ref)
        log(f"planner B: {mode:12s} {disp:5d} dispatches, {syncs:3d} syncs, "
            f"{ms[0]:9.3f} ms/run ({ms[1]:.3f}-{ms[2]:.3f}), peak "
            f"+{peak:.2f} GiB; logits "
            f"{'bit-identical to' if same else 'DIFFER from'} reference")
        if not same:
            raise AssertionError(f"{mode} differs from reference")
    arena = ArenaExecutor(plan, device=device)(env)[g.outputs[0]]
    log(f"planner B: ArenaExecutor logits "
        f"{'bit-identical to' if torch.equal(arena, ref) else 'DIFFER from'}"
        f" reference; resident: fp32 weights "
        f"{sum(p.numel() for p in lm.parameters()) * 4 / 2**30:.2f} GiB, "
        f"all {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if not torch.equal(arena, ref):
        raise AssertionError("ArenaExecutor differs from reference")
    del api, lm, g, make, plan, env, res, ref, arena
    clear_compile_cache()
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phases 3d and 10-13: mamba2-370m on ssd_scan
# --------------------------------------------------------------------------

def ssd_inputs(rng, b, S, H, G, device, strided):
    """The JAX suite's distributions at mamba2-370m's P and N.  Strided:
    x, B and C sliced out of one projection-like buffer and dt out of a
    wider one, as the DAG's scan node hands them to the kernel."""
    P, N = SSD_P, SSD_N
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


def ssd_bound(b, S, H, G):
    """The least work that y from a zero state needs.  Operations: the
    recurrence's (``core.flops.ssd_scan_flops``), one multiply-add a
    (token, head, p, n) folding the token into the state and one reading
    y out of it, the decay kept as a per-token scalar.  The chunked
    algorithm (:func:`ssd_chunked_flops`) computes the same y with more at
    every chunk length.  Bytes: x and y, B and C (per group), dt and A,
    each once."""
    from repro_torch.core.flops import ssd_scan_flops

    flops = ssd_scan_flops(b, S, H, SSD_P, SSD_N)
    nbytes = 4 * (2 * b * S * H * SSD_P + 2 * b * S * G * SSD_N
                  + b * S * H + H)
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_chunked_flops(b, S, H, L):
    """The chunked algorithm's own count on these inputs, the kernel's:
    per (batch, head, chunk) C.B^T over the causal triangle 2 L(L+1)/2 N
    and its product with x.dt 2 L(L+1)/2 P; per chunk boundary the state
    folded in and read out, 2 L P N each (no read of the zero start
    state, no fold of the last chunk, whose state is discarded)."""
    P, N = SSD_P, SSD_N
    tri = L * (L + 1) // 2
    nc = S // L
    return b * H * (nc * 2 * tri * (N + P) + (nc - 1) * 4 * L * P * N)


def ssd_phase(ss, device):
    """ssd_scan against its plain version and the sequential recurrence in
    three cases; returns (max abs err, timing at the prefill shape)."""
    rng = np.random.default_rng(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    worst, timing = 0.0, None
    for label, b, S, H, G, L, strided in SSD_CASES:
        args = ssd_inputs(rng, b, S, H, G, device, strided)
        got = ss.ssd_scan(*args, L)
        again = ss.ssd_scan(*args, L)
        for what, want in (("plain", ss.ssd_scan_plain(*args, L)),
                           ("sequential", ss.ssd_scan_ref(*args)[0])):
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL)
            log(f"ssd_scan {label} b={b} S={S} H={H} G={G} L={L} P={SSD_P} "
                f"N={SSD_N}{' strided' if strided else ''}: vs {what} max "
                f"abs err {e:.3e} on |y| <= {want.abs().max().item():.2f} "
                f"(rtol=atol={SSD_TOL}: {'holds' if ok else 'FAILS'})")
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with its {what} "
                                     f"version ({label})")
            worst = max(worst, e)
        if not torch.equal(got, again):
            raise AssertionError("ssd_scan reruns differ")
        t = dict(ms=median_ms(lambda: ss.ssd_scan(*args, L), flush),
                 plain_ms=median_ms(lambda: ss.ssd_scan_plain(*args, L),
                                    flush),
                 bound=ssd_bound(b, S, H, G), library_ms=None)
        log(f"ssd_scan {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}); reruns bit-identical")
        if timing is None:
            timing = t
            chunked = ssd_chunked_flops(b, S, H, L)
            log(f"ssd_scan {label}: the bound's operations are the "
                f"recurrence's; the chunked algorithm's own count "
                f"{chunked / 1e9:.3f} GFLOP would take "
                f"{chunked / PEAK_FLOPS[torch.float32] * 1e3:.5f} ms at "
                f"the fp32 peak")
        del args, got, again
    del flush
    torch.cuda.empty_cache()
    return worst, timing


def scan_precision(api, params, ss, device):
    """The scan at the model's own inputs: layer 0's operands from one
    bf16 ``prefill_fn`` call, through the kernel and the plain version,
    each against the sequential recurrence in float64."""
    import repro_torch.models.ssm as ssm

    cfg = api.cfg
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)
    kernel, seen = ssm.ssd_scan, []

    def keep(*args, **kwargs):
        if not seen:
            seen.append(tuple(t.clone() for t in args[:5]))
        return kernel(*args, **kwargs)

    ssm.ssd_scan = keep
    try:
        with torch.no_grad():
            api.prefill_fn(params, {"tokens": tokens})
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
    the op-by-op oracle, one ssd_scan launch per layer per run."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ParallaxConfig, clear_compile_cache,
                                  compile_plan, compile_schedule)
    from repro_torch.core.executor import to_device
    from repro_torch.models import build_model
    from repro_torch.models.dag_export import export_decoder_graph

    cfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    lm = build_model(cfg, device=device, dtype="float32").init(
        torch.Generator(device=device).manual_seed(0))
    g, make = export_decoder_graph(cfg, lm, DAG_BATCH, DAG_SEQ)
    export_s = time.perf_counter() - t0
    scans = [n for n in g.nodes.values() if n.name.endswith(".ssd_scan")]
    if len(scans) != cfg.num_layers or any(n.supported for n in scans):
        raise AssertionError("the DAG lacks its unsupported scan nodes")
    budget = torch.cuda.mem_get_info(device)[0]
    plan = compile_plan(g, ParallaxConfig(budget=budget))
    stats = compile_schedule(plan, donate=True).stats
    env = to_device(make(np.random.default_rng(0)), device)
    ss.reset_launches()
    oracle = g.execute(env)[g.outputs[0]]
    torch.cuda.synchronize()
    if ss.launches["ssd_scan"] != cfg.num_layers:
        raise AssertionError("the oracle did not run the kernel per layer")
    log(f"mamba planner: {cfg.name} full width and depth ({cfg.num_layers} "
        f"layers, fp32), batch {DAG_BATCH}, seq {DAG_SEQ} (one chunk of "
        f"{cfg.ssm.chunk}): {g.num_nodes()} nodes, {len(scans)} unsupported "
        f"scan nodes, built+exported in {export_s:.1f} s; "
        f"{len(plan.branches)} branches, {len(plan.layers)} layers, {stats}")
    if oracle.shape != (DAG_BATCH, DAG_SEQ, cfg.vocab_size) \
            or not torch.isfinite(oracle).all():
        raise AssertionError("malformed logits")
    modes = {"reference": dict(mode="reference"), "fused": dict()}
    ss.reset_launches()
    res = run_modes(plan, env, device, modes, MAMBA_RUNS)
    runs = len(modes) * (1 + MAMBA_RUNS)
    launched = ss.launches["ssd_scan"]
    log(f"mamba planner: {launched} ssd_scan launches in {runs} runs "
        f"({launched / runs:.0f} per run)")
    if launched != cfg.num_layers * runs:
        raise AssertionError("not one ssd_scan launch per layer per run")
    for mode, (o, disp, syncs, ms, peak) in res.items():
        same = torch.equal(o, oracle)
        e = (o - oracle).abs().max().item()
        log(f"mamba planner: {mode:9s} {disp:4d} dispatches, {syncs:3d} "
            f"syncs, {ms[0]:8.3f} ms/run ({ms[1]:.3f}-{ms[2]:.3f}), peak "
            f"+{peak:.2f} GiB; vs the oracle: max abs {e:.3e}, "
            f"{'bit-identical' if same else 'not bit-identical'}")
        if not torch.allclose(o, oracle, rtol=SSD_TOL, atol=SSD_TOL):
            raise AssertionError(f"{mode} off the oracle")
    del lm, g, make, plan, env, res, oracle
    clear_compile_cache()
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

    launched = prefill_phase(
        api, params, ss, "ssd_scan",
        ("repro_torch.models.ssm", "ssd_scan", ssd_scan_plain),
        MAMBA_XCHECK, device, tol=MAMBA_PREFILL_TOL, readings=(
            (f"at chunk {cfg.ssm.chunk // 2}", plain_half_chunk),
            ("faulty: with y rounded to bf16", plain_y_bf16),
            ("faulty: on dt rounded to bf16", plain_dt_bf16)))
    scan_precision(api, params, ss, device)
    step_profile(api, params, device)
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), dtype=torch.int32,
        device=device)
    # the bf16 projections at the tensor-core peak plus 48 scans at their
    # bound: in_proj and out_proj over every token, the tied head over the
    # last token only (the embedding is a gather), over 989 TFLOP/s; and
    # ssd_bound per layer
    proj = sum(p.numel() for n, p in params.named_parameters()
               if n.endswith(("in_proj", "out_proj")))
    matmul_ms = (2 * (proj * PREFILL_B * PREFILL_S
                      + params.embed.numel() * PREFILL_B)
                 / PEAK_FLOPS[torch.bfloat16] * 1e3)
    scan_ms = cfg.num_layers * ssd_bound(PREFILL_B, PREFILL_S, 32, 1)[0]
    device_profile(f"{cfg.name} prefill_fn (B={PREFILL_B}, S={PREFILL_S})",
                   lambda: api.prefill_fn(params, {"tokens": tokens}), 2,
                   (matmul_ms + scan_ms, f"projection ({matmul_ms:.3f} ms) "
                    f"+ scan ({scan_ms:.3f} ms)"))
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
    calls = count_calls(api)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    streams, eng, wall = serve_full_width(api, params, 8, True)
    main_launches = dict(pa.launches)
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(t) for t in streams.values())
    log(f"serve: 8/8 requests, {n_tok} tokens in {wall:.3f} s "
        f"({n_tok / wall:.1f} tok/s), {eng.dispatches} dispatches "
        f"({eng.dispatches / n_tok:.4f} per token), {eng.megasteps} "
        f"megasteps, {calls[0]} decode_fn calls, shared block hits "
        f"{eng.kv.shared_block_hits}, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"launches on the main path: {main_launches}")
    for name, n in main_launches.items():
        if n != cfg.num_layers * calls[0]:
            raise AssertionError(f"{name}: {n} launches for {calls[0]} "
                                 f"decode_fn calls x {cfg.num_layers} "
                                 f"layers")
    if eng.kv.shared_block_hits == 0:
        raise AssertionError("prefix sharing never engaged")

    # phase 5: identity across megastep N and sharing
    for megastep, sharing in ((1, True), (8, False)):
        other, e2, w2 = serve_full_width(api, params, megastep, sharing)
        same = other == streams
        log(f"identity: megastep {megastep}, sharing {sharing}: streams "
            f"{'bit-identical' if same else 'DIFFER'} ({w2:.3f} s, "
            f"{e2.dispatches} dispatches)")
        if not same:
            raise AssertionError("greedy streams differ")
    del eng, e2
    main_launches["decode_attention"] = dense_serve_phase(
        api, params, calls, streams, pa, da)
    main_launches["flash_attention"] = prefill_phase(
        api, params, fa, "flash_attention",
        ("repro_torch.kernels.flash_attention.flash_attention",
         "flash_attention", fa.flash_attention_plain), XCHECK_PROMPT,
        device)
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
    main_launches["branch_matmul"] = planner_kernel_path(bm, device)
    planner_model_dag(device)
    main_launches["ssd_scan"] = mamba_phases(ss, count_calls, device)

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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
