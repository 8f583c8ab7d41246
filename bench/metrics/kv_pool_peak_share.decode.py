"""Peak KV blocks in use (the high water of the ``kv.blocks_live``
gauge) over the paged pool's blocks, in %."""


def read(ctx):
    run = ctx["run"]
    if not run.get("kv_blocks"):
        return None
    return 100.0 * run["kv_blocks_peak"] / run["kv_blocks"]
