"""group_norm_roofline.loki: % of its memory roofline that the U-Net's
GroupNorm (``models.layers.group_norm``) reaches in the loki window. Bytes:
x read once and y written once, from each call's shapes; time: the device
time of every operation launched inside the calls (matched through the
trace's launch correlation), whatever kernels implement them. Bound: bytes
over 3.35 TB/s (H100 SXM HBM3)."""

from benchmark.spans import HBM, tensor_bytes

SPANS = {"group_norm": "maze_image_processing_pipeline_tpu_torch.models.layers:group_norm"}
SHAPES = {"group_norm"}


def read(run):
    calls = run.shapes.get("group_norm", [])
    t = run.trace.device_seconds_in("group_norm") if run.trace is not None else None
    if not calls or not t:
        return None
    nbytes = sum(2 * tensor_bytes(ins[:1]) for ins, _ in calls)
    return 100.0 * nbytes / HBM / t
