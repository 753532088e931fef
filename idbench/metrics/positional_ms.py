"""Mean device time of ``IndexIVF.search_positional`` (coarse assignment,
scan, merge) over the traced window's calls: CUDA events recorded on the
stream before and after the call."""


def read(ctx):
    ms = ctx.spans["positional"]
    return sum(ms) / len(ms) if ms else None
