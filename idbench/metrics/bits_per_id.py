"""The index's id memory: 8 x (compressed_ids_size_in_bytes +
overhead_in_bytes) / ntotal of the active id container. A memory reading
of the configuration, the same in every traffic mix; it stands beside the
throughput that a change to the id container may buy with bytes."""


def read(ctx):
    c = ctx.container
    return 8.0 * (c.compressed_ids_size_in_bytes + c.overhead_in_bytes) / ctx.ntotal
