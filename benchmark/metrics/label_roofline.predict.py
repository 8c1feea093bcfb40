"""label_roofline.predict: % of its memory roofline that connected-component
labelling (``ops.label.label`` as the fused segment measurement calls it)
reaches in the predict window. Bytes: the mask read once and the int32
labels and counts written once, from each call's shapes; time: the device
time of every operation launched inside the calls (matched through the
trace's launch correlation). Bound: bytes over 3.35 TB/s (H100 SXM)."""

from benchmark.spans import HBM, tensor_bytes

SPANS = {"label": "maze_image_processing_pipeline_tpu_torch.ops.segment_measure:label"}
SHAPES = {"label"}


def read(run):
    calls = run.shapes.get("label", [])
    t = run.trace.device_seconds_in("label") if run.trace is not None else None
    if not calls or not t:
        return None
    nbytes = sum(tensor_bytes(ins[:1]) + tensor_bytes(outs) for ins, outs in calls)
    return 100.0 * nbytes / HBM / t
