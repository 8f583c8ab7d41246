"""The differentiable kernels: ``flash_attention``, ``ssd_scan`` and
``branch_matmul`` through their ``autograd.Function``s.

On the CPU (every wrapper takes its plain version there):

* each wrapper, given an input that requires grad while grad mode is
  on, goes through its Function (its output carries the Function's
  graph), and carries no graph under ``torch.no_grad()``;
* through the Function it gives the plain version's output and
  gradients bit for bit (the Function's backward is autograd of the
  plain version on the saved inputs);
* ``branch_matmul`` gives the rows past a group's count zero gradient,
  as ``jax.lax.ragged_dot`` does;
* the models reach the kernels through the Functions: a reduced model's
  loss back-propagates into the attention, Mamba and expert weights,
  and Whisper's decoder into its cross-attention at one token too;
* remat changes no value: a reduced model's forward under grad mode
  equals it under ``torch.no_grad()`` bit for bit.

The ``cuda`` cases (skipped without a card) hold the Function's forward
to the kernel without a graph and its gradients to autograd of the
plain version, both bit for bit, and count a reduced model's kernel
launches in one forward and backward with remat: two a layer.  This file imports
no JAX, so the card's machine collects it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import branch_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's torch work.  Under xdist,
    with several workers sharing a few cores, torch's default of one
    thread a core in each worker slows these backward passes ~100x
    (measured on 8 cores: 10 mamba2 steps 2.7 s at one thread, 41 s at
    eight, with six other busy processes beside).  Restored after the
    file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flash_args(device, dtype=torch.float32):
    rng = np.random.default_rng(0)
    B, H, K, S, T, D = 2, 4, 2, 12, 12, 16
    return [torch.tensor(rng.standard_normal(s), dtype=dtype, device=device)
            for s in ((B, H, S, D), (B, K, T, D), (B, K, T, D))]


def _ssd_args(device):
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=device)
    return [torch.tensor(rng.standard_normal((1, 16, 4, 8)), **f32),
            torch.tensor(rng.uniform(0.01, 0.2, (1, 16, 4)), **f32),
            -torch.tensor(rng.uniform(0.5, 2.0, 4), **f32),
            torch.tensor(rng.standard_normal((1, 16, 2, 4)), **f32),
            torch.tensor(rng.standard_normal((1, 16, 2, 4)), **f32)]


def _branch_args(device, dtype=torch.float32):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((3, 8, 16)), dtype=dtype,
                     device=device)
    w = torch.tensor(rng.standard_normal((3, 16, 4)), dtype=dtype,
                     device=device)
    counts = torch.tensor([8, 3, 0], dtype=torch.int32, device=device)
    return [x, w], counts


#: (wrapper, plain version, make inputs, keyword arguments, Function)
CASES = {
    "flash_attention": (fa.flash_attention, fa.flash_attention_plain,
                        _flash_args, dict(causal=True, window=0),
                        "FlashAttentionFn"),
    "flash_attention cross": (fa.flash_attention, fa.flash_attention_plain,
                              _flash_args, dict(causal=False, window=0),
                              "FlashAttentionFn"),
    "ssd_scan": (ss.ssd_scan, ss.ssd_scan_plain, _ssd_args, dict(chunk=8),
                 "SSDScanFn"),
    "branch_matmul": (bm.branch_matmul, bm.branch_matmul_plain,
                      lambda d: _branch_args(d)[0], {}, "BranchMatmulFn"),
    "branch_matmul counts": (bm.branch_matmul, bm.branch_matmul_plain,
                             lambda d: _branch_args(d)[0],
                             dict(counts=_branch_args("cpu")[1]),
                             "BranchMatmulFn"),
}


def _grads(fn, inputs, kwargs, seed=5):
    """fn's output and its gradients for a seeded output gradient."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs, **kwargs)
    g = torch.tensor(np.random.default_rng(seed).standard_normal(
        tuple(out.shape)), dtype=out.dtype, device=out.device)
    return out.detach(), torch.autograd.grad(out, xs, g)


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_output_carries_the_functions_graph(case):
    wrapper, plain, make, kwargs, fn = CASES[case]
    inputs = make("cpu")
    for i in range(len(inputs)):          # any one input wanting grad
        xs = [x.detach().requires_grad_(j == i)
              for j, x in enumerate(inputs)]
        out = wrapper(*xs, **kwargs)
        assert type(out.grad_fn).__name__ == f"{fn}Backward", i
        with torch.no_grad():
            out = wrapper(*xs, **kwargs)
        assert out.grad_fn is None
        assert torch.equal(out, plain(*inputs, **kwargs))


@pytest.mark.parametrize("case", list(CASES))
def test_function_gives_the_plain_gradients_on_cpu(case):
    wrapper, plain, make, kwargs, _ = CASES[case]
    inputs = make("cpu")
    out, grads = _grads(wrapper, inputs, kwargs)
    want_out, want = _grads(plain, inputs, kwargs)
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    # nothing requires grad: no graph, the same output
    plain_out = wrapper(*inputs, **kwargs)
    assert plain_out.grad_fn is None and torch.equal(plain_out, out)


def test_branch_matmul_rows_past_the_counts_get_zero_gradient():
    (x, w), counts = _branch_args("cpu")
    _, (gx, gw) = _grads(bm.branch_matmul, (x, w),
                         dict(counts=counts))
    for g, n in enumerate(counts.tolist()):
        assert torch.count_nonzero(gx[g, n:]) == 0
        assert (n == 0) == (torch.count_nonzero(gw[g]) == 0)
        if n:
            assert torch.count_nonzero(gx[g, :n]) > 0


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-370m", "kimi-like"])
def test_models_reach_the_kernels_through_the_functions(arch):
    """A reduced model's loss back-propagates into the weights that feed
    each kernel (attention q/k/v, Mamba in_proj and A_log, the expert
    GEMMs), with nonzero gradients."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import loss_and_grads

    name = "kimi-k2-1t-a32b" if arch == "kimi-like" else arch
    cfg = get_config(name).reduced()
    if arch == "kimi-like":               # moe_ragged: branch_matmul
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=8, layer_offset=1))
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    _, _, grads = loss_and_grads(api, params, {"tokens": toks,
                                               "labels": toks})
    feeds = {"stablelm-3b": ("layers.1.attn.wq", "layers.1.attn.wk",
                             "layers.1.attn.wv"),
             "mamba2-370m": ("layers.1.mamba.in_proj",
                             "layers.1.mamba.A_log",
                             "layers.1.mamba.dt_bias"),
             "kimi-like": ("layers.1.moe.w_gate", "layers.1.moe.w_up",
                           "layers.1.moe.w_down")}[arch]
    for name in feeds:
        assert torch.count_nonzero(grads[name]) > 0, name


def _reduced(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    api = build_model(get_config(arch).reduced(), device="cpu")
    return api, api.init(torch.Generator().manual_seed(0))


def test_whisper_decoder_takes_cross_attention_gradients_at_one_token(
        monkeypatch):
    """At one token the serving cross-attention runs ``decode_attention``,
    whose kernel has no gradient; with a gradient wanted it goes through
    ``flash_attention`` instead, so the cross-attention weights train."""
    from repro_torch.models import attention, stub_audio_frontend
    from repro_torch.training import loss_and_grads

    def no_graph(*args, **kwargs):
        raise AssertionError("decode_attention on the training path")

    monkeypatch.setattr(attention, "decode_attention", no_graph)

    api, params = _reduced("whisper-tiny")
    cfg = api.cfg
    toks = torch.randint(0, cfg.vocab_size, (2, 1),
                         generator=torch.Generator().manual_seed(1))
    frames = stub_audio_frontend(torch.Generator().manual_seed(2), cfg, 2,
                                 cfg.encoder_seq)
    _, _, grads = loss_and_grads(api, params, {
        "frames": frames, "tokens": toks, "labels": toks})
    for name in ("decoder.0.cross_attn.wq", "decoder.0.cross_attn.wo",
                 "encoder.0.attn.wq"):
        assert torch.count_nonzero(grads[name]) > 0, name


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-370m"])
def test_remat_changes_no_value(arch):
    """``forward_lm`` checkpoints every layer while grad mode is on; the
    hidden states and aux loss equal the no-grad forward's bit for
    bit."""
    from repro_torch.models.transformer import forward_lm

    api, params = _reduced(arch)
    for p in params.parameters():
        p.requires_grad_(True)
    toks = torch.randint(0, api.cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    hid, aux = forward_lm(params, api.cfg, toks)
    assert hid.grad_fn is not None
    with torch.no_grad():
        want, want_aux = forward_lm(params, api.cfg, toks)
    assert torch.equal(hid.detach(), want) and float(aux) == float(want_aux)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.device import deterministic
    deterministic()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_function_on_the_card(cuda, case):
    """Forward bit-equal to the kernel without a graph, gradients
    bit-equal to autograd of the plain version, one launch a forward."""
    wrapper, plain, make, kwargs, _ = CASES[case]
    kwargs = {k: v.to(cuda) if torch.is_tensor(v) else v
              for k, v in kwargs.items()}
    name = case.split()[0]
    counts = {"flash_attention": fa.launches, "ssd_scan": ss.launches,
              "branch_matmul": bm.launches}[name]
    inputs = make(cuda)
    with torch.no_grad():
        want_out = wrapper(*inputs, **kwargs)
    before = counts[name]
    out, grads = _grads(wrapper, inputs, kwargs)
    torch.cuda.synchronize()
    assert counts[name] == before + 1
    assert torch.equal(out, want_out)
    _, want = _grads(plain, inputs, kwargs)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-370m"])
def test_remat_launches_each_kernel_twice_a_layer(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    api = build_model(cfg, device=cuda)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    for p in params.parameters():
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    counts, key = ((fa.launches, "flash_attention") if arch == "stablelm-3b"
                   else (ss.launches, "ssd_scan"))
    before = counts[key]
    loss, _ = api.loss_fn(params, {"tokens": toks, "labels": toks})
    loss.backward()
    torch.cuda.synchronize()
    assert counts[key] - before == 2 * cfg.num_layers
