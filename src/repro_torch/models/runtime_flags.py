"""Process-wide model-lowering flags.

Port of ``repro.models.runtime_flags``, without ``scan_unroll`` and
``scan_kwargs``: the port's layers run as a Python loop (no
``lax.scan``), so every layer is dispatched, and counted, on its own.
JAX's dry-run unrolls its scans, and probes one- and two-period models
to extrapolate (``_layer_probe_cfgs``), only because XLA's
``cost_analysis`` counts a while-loop body once; the port's dry-run
counts every dispatched op and needs neither.

``chunked_attention`` (§Perf O5): exact online-softmax attention over
(``chunk_q``, ``chunk_k``) tiles for long causal sequences, so the S x S
score matrix is never materialised.  It routes the plain path
(CPU and fake tensors, as in the dry-run) to
``attention.attend_chunked``; on the card attention stays on the
``flash_attention`` kernel, which never materialises S x S either.

``shard_ssm_heads`` (§Perf O6): constrain the Mamba SSD head tensors to
the ``model`` mesh axis under an active mesh.
"""

chunked_attention = False
chunk_q = 512
chunk_k = 1024

shard_ssm_heads = False
