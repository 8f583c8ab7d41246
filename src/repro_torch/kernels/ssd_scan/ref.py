"""The plain SSD (Mamba-2) math: the chunked algorithm and its sequential
oracle.

Copies of ``segsum``, ``ssd_chunked`` and ``ssd_scan_ref`` from
``repro.models.ssm``, in PyTorch, with the JAX package's layout::

    x (b, S, H, P)   dt (b, S, H)   A (H,) negative   B, C (b, S, G, N)

with G groups broadcast over H // G heads.  ``ssd_chunked`` is the
plain version of the ``ssd_scan`` kernel (``initial_state=None``), and
``ssd_scan_ref`` — one recurrence step per token — is the exact oracle
both are held to.  :mod:`repro_torch.models.ssm` re-exports all three.
"""

from __future__ import annotations

import torch


def segsum(x):
    """Stable 'segment sum' producing pairwise decay exponents.

    x: (..., L).  Returns (..., L, L) with out[i, j] = sum_{j < k <= i} x_k
    for j <= i, -inf above the diagonal.
    """
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x:  (b, S, H, P)   dt: (b, S, H)    A: (H,) negative
    B, C: (b, S, G, N) with G groups broadcast over H // G heads.
    Returns (y (b,S,H,P), final_state (b,H,P,N)).
    """
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    rep = H // G

    # broadcast groups to heads
    Bh = B.repeat_interleave(rep, dim=2)              # (b,S,H,N)
    Ch = C.repeat_interleave(rep, dim=2)

    def r(t, last):  # reshape into chunks
        return t.reshape((b, nc, chunk) + last)

    xc = r(x, (H, Pd))
    dtc = r(dt, (H,))
    Bc = r(Bh, (H, N))
    Cc = r(Ch, (H, N))

    dA = dtc * A[None, None, None, :]                 # (b,nc,L,H)
    dA = torch.movedim(dA, -1, 2)                     # (b,nc,H,L)
    dA_cs = torch.cumsum(dA, dim=-1)                  # within-chunk cumsum

    # 1) intra-chunk (diagonal blocks): Y_diag = (C B^T ∘ decay) (x*dt)
    Ldec = torch.exp(segsum(dA))                      # (b,nc,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    gated = scores * Ldec
    xdt = xc * dtc[..., None]                         # (b,nc,L,H,P)
    y_diag = torch.einsum("bchls,bcshp->bclhp", gated, xdt)

    # 2) chunk states: decay-to-end weighted outer products
    decay_end = torch.exp(dA_cs[..., -1:] - dA_cs)    # (b,nc,H,L)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, decay_end, xdt)

    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cs[..., -1])           # (b,nc,H)
    state = (torch.zeros((b, H, Pd, N), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for c in range(nc):
        prev.append(state)                            # state *before*
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)            # (b,nc,H,P,N)

    # 4) off-diagonal contribution: read previous state into the chunk
    state_decay = torch.exp(dA_cs)                    # decay from start
    y_off = torch.einsum("bclhn,bchl,bchpn->bclhp", Cc, state_decay,
                         prev_states)

    y = (y_diag + y_off).reshape(b, S, H, Pd)
    return y, state


def ssd_scan_ref(x, dt, A, B, C, initial_state=None):
    """Sequential-recurrence oracle (O(S) steps, exact)."""
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    h = (torch.zeros((b, H, Pd, N), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state)
    ys = []
    for t in range(S):
        dtt = dt[:, t]                                 # (b,H)
        decay = torch.exp(dtt * A[None, :])
        upd = torch.einsum("bhn,bhp->bhpn", Bh[:, t],
                           x[:, t] * dtt[..., None])
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h
