"""setup_s: process start to the first timed unit (imports, the kernels'
build in a fresh checkout, weights, inputs, warm-up), by the host clock."""


def read(run):
    return run.setup_s
