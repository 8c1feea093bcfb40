"""launch_idle_share.<kind>: % of the traced window in which the card ran
nothing while the device node's thread was inside its dispatch
(``loki.dispatch`` / ``predict.chunk``: tile selection or cutting, upload,
the launches): the card waiting for the host to launch. The program's spans
(the port's ``tracing``, host clock) are moved onto the trace's clock by the
offset the program measured when tracing was turned on; the card's busy
time is the union of its operations in the trace. Idle inside the spans =
|spans ∪ busy| − |busy|, both clipped to the window. A program without the
spans reads nothing."""

from benchmark.spans import union_seconds

NODE = {"loki": "loki.dispatch", "predict": "predict.chunk"}


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
    if tracing is None or run.trace is None or run.trace.window is None:
        return None
    off = tracing.clock_offset_ns()
    name = NODE[run.config["kind"]]
    inside = [(s.start_ns + off, s.end_ns + off) for s in tracing.spans() if s.name == name]
    if not inside:
        return None
    lo, hi = run.trace.window
    busy = [(s, e) for s, e, _, _ in run.trace.device]
    idle = union_seconds(inside + busy, lo, hi) - union_seconds(busy, lo, hi)
    return 100.0 * idle / (hi - lo)
