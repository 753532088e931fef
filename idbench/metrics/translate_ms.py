"""Mean device time of ``IndexIVF._translate`` (labels to ids: for ROC the
grouped translate, ``decode_select`` and one decode launch over the
touched lists) over the traced window's calls: CUDA events on the stream."""


def read(ctx):
    ms = ctx.spans["translate"]
    return sum(ms) / len(ms) if ms else None
