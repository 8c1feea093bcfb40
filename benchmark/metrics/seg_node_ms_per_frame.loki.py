"""seg_node_ms_per_frame.loki: host milliseconds inside the loki device
node's calls (``_dispatch_group`` + ``_finish_group``, the fetch's wait for
the card included) per frame of the window."""


def spans(kind):
    return kind.NODE_SPANS


def read(run):
    ivs = [iv for name in run.kind.NODE_SPANS for iv in run.spans.get(name, [])]
    if not ivs or not run.work.get("frames"):
        return None
    return 1000.0 * sum(e - s for s, e in ivs) / run.work["frames"]
