"""predict_objects_per_s: objects through ``maze-ipp predict`` over the
window's wall time, all archives of the window together."""


def read(run):
    return run.work["objects"] / run.window_s if "objects" in run.work else None
