"""Seconds from the process's start to the first timed call: imports,
CUDA context, inputs, the index's build, the kernel library's load (its
nvcc build in a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
