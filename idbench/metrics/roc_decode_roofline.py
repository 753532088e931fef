"""K1's share of its roofline: the least time the card could take for the
ROC decodes launched in the profiled calls (``roofline.py``: the lanes'
stream bytes read once and the ids written once over the memory bandwidth,
or the order statistics over the scalar rate, whichever is larger),
over the summed time of the profiler's ``roc_decode_kernel`` events."""

import importlib

roofline = importlib.import_module("idbench.roofline")
KERNEL = "roc_decode_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    runs = [(c, s) for name, (c, s) in ctx.trace.kernels.items() if KERNEL in name]
    seconds = sum(s for _, s in runs)
    launches = sum(c for c, _ in runs)
    decodes = [(d, idx) for d, idx in ctx.decodes if idx.numel()]
    if seconds <= 0 or launches != len(decodes):
        return None
    least = 0.0
    for d, idx in decodes:
        lengths = d.lengths[idx].tolist()
        stack_len = d.states.stack_len[idx].tolist()
        least += roofline.least_seconds(roofline.roc_decode_bytes(lengths, stack_len, d.n_max),
                                        roofline.roc_decode_ops(lengths), ctx.peaks)
    return 100.0 * least / seconds
