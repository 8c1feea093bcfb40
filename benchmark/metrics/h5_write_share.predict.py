"""h5_write_share.predict: % of the window's wall time inside the ``.h5``
writer's work (``dataio.hdf5.HDF5Writer._create``: shuffle, DEFLATE and
write of each map; ``_File.close``: the metadata), by the host clock."""

from benchmark.spans import union_seconds

H5 = "maze_image_processing_pipeline_tpu_torch.dataio.hdf5"
SPANS = {"h5.create": H5 + ":HDF5Writer._create", "h5.close": H5 + ":_File.close"}


def read(run):
    ivs = run.spans.get("h5.create", []) + run.spans.get("h5.close", [])
    if not ivs:
        return None
    return 100.0 * union_seconds(ivs, *run.window) / run.window_s
