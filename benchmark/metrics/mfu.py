"""mfu.<kind>: % of the card's bf16 dense peak (989 TFLOP/s, H100 SXM) that
the U-Net forwards of the window reach over its wall time. The FLOPs are
the convolutions' multiply-adds of every tile the device node ran (the
kind's ``TILE_CALL``: loki's ``_predict`` jobs, predict's ``_forward``
tiles, the batch's zero padding left out), from the kind's tile size and
the configuration's widths (:func:`benchmark.unet_ref.forward_flops`)."""

from benchmark.unet_ref import forward_flops

PEAK = 989e12


def install(rec, counters, kind):
    target, arg = kind.TILE_CALL

    def after(args, kwargs, out):
        if rec.active:
            counters["tiles"] = counters.get("tiles", 0) + len(args[arg])

    rec.wrap(target, after=after)


def read(run):
    tiles = run.counters.get("tiles")
    if not tiles:
        return None
    m, ts = run.config["model"], run.kind.tile_size(run.config)
    flops = tiles * forward_flops(ts, ts, m["out_channels"], m["base_features"], m["depth"])
    return 100.0 * flops / (run.window_s * PEAK)
