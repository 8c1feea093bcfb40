"""mfu.<kind>: % of the card's bf16 dense peak (989 TFLOP/s, H100 SXM) that
the model's forwards of the window reach over its wall time. The FLOPs are
those of every tile the device node ran (the kind's ``TILE_CALL``: loki's
``_predict`` jobs, predict's ``_forward`` tiles, the batch's zero padding
left out), one forward a tile at the kind's tile size, as the
configuration's architecture counts them (``archs/<arch>.py:forward_flops``;
the U-Net's: :func:`benchmark.unet_ref.forward_flops`)."""

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
    ts = run.kind.tile_size(run.config)
    flops = tiles * run.arch.forward_flops(run.config["model"], ts, ts)
    return 100.0 * flops / (run.window_s * PEAK)
