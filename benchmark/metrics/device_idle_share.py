"""device_idle_share.<kind>: % of the traced window in which no operation
ran on the card: 1 − the union of the device activity intervals (kernels,
copies, sets; overlapping ones counted once) over the window."""


def read(run):
    w = run.trace.window_seconds() if run.trace is not None else 0.0
    return 100.0 * (1.0 - run.trace.busy_seconds() / w) if w else None
