"""items_per_s: every item scored in the window over the window's seconds
(host clock; the window ends when the last step's scores are on the
host)."""


def read(run):
    return run.items / run.window_s if run.steps else None
