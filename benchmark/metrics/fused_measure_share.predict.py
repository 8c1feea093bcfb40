"""fused_measure_share.predict: % of the window's wall time that the card
spends in the operations launched by the fused segment measurement
(``ops.segment_measure.measure_channels_packed``: thresholds, hole filling,
labelling, the largest component's moments and row extremes), from the
trace."""

SPANS = {"measure": "maze_image_processing_pipeline_tpu_torch.ops.segment_measure:measure_channels_packed"}


def read(run):
    if run.trace is None or not run.trace.window_seconds():
        return None
    t = run.trace.device_seconds_in("measure")
    return None if t is None else 100.0 * t / run.trace.window_seconds()
