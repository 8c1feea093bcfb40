"""unit_build_share.<kind>: % of the window spent starting units: the
union of the program's ``unit.build`` spans (each Runner start's task
validation, mesh set-up, model load and pipeline construction, up to the
pipeline's run), clipped to the window, by the host clock. The spans are
the port's own (``tracing``); a program without them reads nothing."""

from benchmark.spans import union_seconds

SPAN = "unit.build"


def _tracing():
    try:
        from maze_image_processing_pipeline_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def install(rec, counters, kind):
    """The program's spans on from here (after the warm-up), none kept from before."""
    tracing = _tracing()
    if tracing is not None:
        tracing.reset()
        tracing.enable()


def read(run):
    tracing = _tracing()
    if tracing is None:
        return None
    ivs = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in tracing.spans() if s.name == SPAN]
    if not ivs:
        return None
    return 100.0 * union_seconds(ivs, *run.window) / run.window_s
