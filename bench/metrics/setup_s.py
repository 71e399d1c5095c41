"""setup_s: from the process's start to the window's start: imports, the
card's start, the kernels' build or load, the weights and the traffic's
pool drawn on the card, the warm-up steps."""


def read(run):
    return run.setup_s
