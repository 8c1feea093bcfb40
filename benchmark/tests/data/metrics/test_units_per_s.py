"""test_units_per_s: a test-only end-to-end metric, added as a file: the
frames of the window over its wall time, as loki_frames_per_s reads them."""


def read(run):
    return run.work.get("frames", 0.0) / run.window_s
