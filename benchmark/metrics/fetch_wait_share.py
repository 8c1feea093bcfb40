"""fetch_wait_share.<kind>: % of the window in which the host waited for
the card: the union of the program's ``loki.fetch_wait`` /
``predict.fetch_wait`` spans (the device node's blocking device-to-host
copies of its results), clipped to the window, by the host clock. The spans
are the port's own (``tracing``); a program without them reads nothing."""

from benchmark.spans import union_seconds

SPAN = {"loki": "loki.fetch_wait", "predict": "predict.fetch_wait"}


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
    name = SPAN[run.config["kind"]]
    ivs = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in tracing.spans() if s.name == name]
    if not ivs:
        return None
    return 100.0 * union_seconds(ivs, *run.window) / run.window_s
