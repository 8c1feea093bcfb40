"""output_wait_share.<kind>: % of the window in which the device node's
thread waited to hand on its results, so that the stages downstream set the
pace: the union of the program's ``queue.put_wait`` spans (a blocking
``put`` into the stream engine queue behind the node) in the threads that
ran the node's dispatch (``loki.dispatch`` / ``predict.chunk``; each unit's
threads apart), clipped to the window, by the host clock. The spans are the
port's own (``tracing``); a program without them reads nothing."""

from benchmark.spans import union_seconds

NODE = {"loki": "loki.dispatch", "predict": "predict.chunk"}
WAIT = "queue.put_wait"


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
    recorded = tracing.spans()
    node = {(s.unit, s.thread) for s in recorded if s.name == NODE[run.config["kind"]]}
    if not node:
        return None
    ivs = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in recorded if s.name == WAIT and (s.unit, s.thread) in node]
    return 100.0 * union_seconds(ivs, *run.window) / run.window_s
