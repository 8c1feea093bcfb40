"""loki_frames_per_s: LOKI frames re-segmented and written as EcoTaxa
archives over the window's wall time, all hauls of the window together."""


def read(run):
    return run.work["frames"] / run.window_s if "frames" in run.work else None
