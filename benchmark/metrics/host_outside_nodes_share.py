"""host_outside_nodes_share.<kind>: % of the window's wall time outside the
device node's calls that the cell's kind names (``NODE_SPANS``; loki:
``_dispatch_group`` and ``_finish_group``; predict: ``_run_chunk`` and
``_unpack_chunk``): the Runner, the stream engine, reading and decoding,
and the writers."""

from benchmark.spans import union_seconds


def spans(kind):
    return kind.NODE_SPANS


def read(run):
    ivs = [iv for name in run.kind.NODE_SPANS for iv in run.spans.get(name, [])]
    if not ivs:
        return None
    return 100.0 * (1.0 - union_seconds(ivs, *run.window) / run.window_s)
