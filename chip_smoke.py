"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. card: the GPU's name and power limit, from ``nvidia-smi``;
2. build: both CUDA kernels from ``src/repro_torch/csrc/`` (one ``nvcc``
   each, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (B=8, H=K=32, D=80, block 16, ragged lengths
   with 0 and a full row, unallocated table entries on the scratch row),
   plus a GQA case (K=8) and a windowed case, in bf16 and fp32
   (tolerance fp32 2e-5, bf16 2e-2; pools after the append bit-exact);
   median times by CUDA events beside the bytes bound;
4. serve: ``stablelm-3b`` at full width (32 layers, d_model 2560, bf16,
   random weights from ``torch.Generator`` seed 0) through
   ``ContinuousEngine`` with the paged pool, prefix sharing and megastep
   8: 8 seeded requests, prompts of 16-128 tokens (two share a 32-token
   prefix), 32 new tokens each.  Launch counts are zeroed just before
   and read just after: every ``decode_fn`` call must launch each kernel
   once per layer;
5. identity: the same workload at megastep 1 and with sharing off must
   give bit-identical greedy streams;
6. reference: the reduced fp32 model on the card against the same
   weights on the CPU (plain versions), a few decode steps, fp32 2e-5;
   then where one full-width decode step spends its time (host clock,
   ``torch.profiler``);
7. CLI: ``repro_torch.launch.serve.serve("stablelm-3b",
   engine_mode="continuous")`` on the card.

The last two lines are the ``kernels`` JSON object and the result
object ``{"ok": true, "device": {...}}``.  Without a card, or without
the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

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

KERNELS = {
    "paged_decode_attention": dict(
        source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:88"),
    "paged_append": dict(
        source="src/repro_torch/csrc/paged_append.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:159"),
}


def log(*args):
    print(*args, flush=True)


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
    row, its table entries and length, the output."""
    K = k_pool.shape[2]
    item = q.element_size()
    n_tok = lens.long() + 1
    if window > 0:
        n_tok = n_tok.clamp(max=window)
    n_tok = int(n_tok.sum())
    n_blk = int((lens.long() // BS + 1).sum())
    nbytes = (2 * q.numel() * item + 2 * n_tok * K * D * item
              + 4 * n_blk + 4 * B)
    flops = 4 * n_tok * (H // K) * K * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
            if dtype == torch.bfloat16 and K == H and window == 0:
                timing["paged_decode_attention"] = dict(
                    ms=median_ms(lambda: pa.paged_decode_attention(
                        q, kp, vp, tables, lens), flush),
                    plain_ms=median_ms(
                        lambda: pa.paged_decode_attention_plain(
                            q, kp, vp, tables, lens), flush),
                    bound=decode_bound(q, kp, lens, 0))
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


def serve_full_width(api, params, megastep, sharing):
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine

    eng = ContinuousEngine(api, params, device=api.device,
                           config=EngineConfig(
                               hbm_budget=4 << 30, max_batch=B,
                               megastep=megastep, paged=True,
                               prefix_sharing=sharing, block_size=BS,
                               max_context=MAX_CONTEXT))
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


def step_profile(api, params, device):
    """Where one full-width ``decode_fn`` call (B=8, every row at
    position 100) spends its time: host+device wall time by the host
    clock, and the card's busy time by ``torch.profiler`` (the sum of its
    kernels, which run in order on one stream), split by kernel family.
    The weight bytes over the memory rate bound the step from below."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    caches = api.init_paged_caches(B, B * BPR, BS)
    batch = {"tokens": torch.zeros(B, 1, dtype=torch.int32, device=device),
             "cache_len": torch.full((B,), 100, dtype=torch.int32,
                                     device=device),
             "active": torch.ones(B, dtype=torch.bool, device=device),
             "block_tables": torch.arange(B * BPR, dtype=torch.int32,
                                          device=device).reshape(B, BPR)}
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    n = 5
    with torch.no_grad():
        for _ in range(3):
            api.decode_fn(params, caches, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            api.decode_fn(params, caches, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                api.decode_fn(params, caches, batch)
            torch.cuda.synchronize()
    by_family: "dict[str, float]" = {}
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        if "paged_decode" in name:
            family = "paged_decode_attention"
        elif "paged_append" in name:
            family = "paged_append"
        elif any(k in name for k in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet", "splitk")):
            family = "matmul"
        else:
            family = "other (elementwise, norms, rope, sampling)"
        by_family[family] = (by_family.get(family, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / n)
        launches += 1
    busy = sum(by_family.values())
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    if busy == 0.0:
        log(f"step: full-width decode_fn (B=8, position 100): wall "
            f"{wall:.3f} ms; device time not measured (the profiler saw "
            f"no kernels); weight-read bound {bound:.3f} ms")
        return
    log(f"step: full-width decode_fn (B=8, position 100): wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms ({launches / n:.0f} "
        f"kernels), idle share {1 - busy / wall:.3f}, weight-read bound "
        f"{bound:.3f} ms")
    for family, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"step:   {family}: {ms:.3f} ms ({ms / busy:.1%} of busy)")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.device import deterministic
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
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
    calls = [0]
    decode_fn = api.decode_fn

    def counted(*args, **kwargs):
        calls[0] += 1
        return decode_fn(*args, **kwargs)

    api.decode_fn = counted
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
    step_profile(api, params, device)
    del api, params, eng
    torch.cuda.empty_cache()

    reference_phase(device)

    from repro_torch.launch.serve import serve
    done = serve("stablelm-3b", engine_mode="continuous")
    if not all(c.ok for c in done.values()):
        raise AssertionError("CLI serve did not complete every request")
    log(f"cli: serve('stablelm-3b', engine_mode='continuous') completed "
        f"{len(done)} requests on {torch.cuda.get_device_name(0)}")

    rows = []
    for name, meta in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"],
                     "launches": main_launches[name],
                     "max_abs_err": err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
