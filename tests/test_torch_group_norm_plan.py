"""The plan of the one-launch GroupNorm kernels K5 and K6
(``models.layers.norm_plan``) and their launch contract.

On the CPU the plan is held to what ``csrc/group_norm.cu`` relies on, at
the norms of the haul's path, the full-width train step, the
distillation's U-Net and odd shapes, both layouts, both kernels, with an
H100's numbers (132 SMs, two blocks an SM, 106,368 stageable bytes a
block: half of an SM's 228 KB less the 1 KB reserve and the 9,344-byte
scratch) and with a small card: every unit's blocks run in one wave, the
shares cover each unit exactly, a block stages at most 232,448 bytes, the
grid fits the co-resident capacity, and (K6 NCHW) a share touches at most
64 channel planes in at most 128 pieces. The mode switches to two passes
exactly where a unit outgrows the card's shared memory.

On the card (``cuda``-marked tests, skipped here): one device operation a
call (``tools/norm_ops.py`` under ``torch.profiler``, in a process of its
own) and no host synchronisation; both modes, at shapes that force each,
against the plain versions at the existing tolerances (K5 float32 rtol /
atol 1e-5, 16-bit within one ulp; K6 dx rtol 1e-4 plus 1e-5 of its largest
magnitude, or one ulp) and the same bits from two calls.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.models import layers

H100 = (132 * 2, 115712 - 9344)  # co-resident blocks, stageable bytes a block
SMALL = (8, 4096)
MAX_STAGED = 232448

PATH = [(16, 32, 1024, 1024), (64, 32, 256, 256), (256, 32, 128, 128)]
TRAIN = [(8, 32, 512, 512), (8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32)]
DISTILL = [(8, 32, 128, 128), (8, 64, 64, 64), (8, 128, 32, 32), (8, 256, 16, 16), (8, 512, 8, 8)]
ODD = [(3, 16, 5, 7), (4, 512, 9, 11), (8, 32, 30, 31), (2, 24, 7, 5), (1, 8, 4, 4), (2, 16, 3, 1, 5)]


def _vec(n, itemsize):
    """The wrapper's vector width for an aligned tensor."""
    v = 16 // itemsize
    while n % v:
        v //= 2
    return v


def _plan(shape, channels_last, backward, card=H100, itemsize=2, G=8):
    C, HW = shape[1], math.prod(shape[2:])
    vec = _vec(C if channels_last else HW, itemsize)
    return layers.norm_plan(tuple(shape), min(G, C), channels_last, itemsize, vec, backward, *card), vec


def _layouts(shape):
    return (False, True) if len(shape) == 4 else (False,)


CASES = [(s, cl, bwd, card) for card in (H100, SMALL) for s in PATH + TRAIN + DISTILL + ODD
         for cl in _layouts(s) for bwd in (False, True)]


@pytest.mark.parametrize("shape,channels_last,backward,card", CASES)
def test_plan_fits_the_kernel(shape, channels_last, backward, card):
    for itemsize in (2, 4):
        plan, vec = _plan(shape, channels_last, backward, card, itemsize)
        capacity, stage_bytes = card
        U, vps, splits = plan.unit_vectors, plan.vectors_per_split, plan.splits
        # The shares cover each unit exactly, none empty.
        assert (splits - 1) * vps < U <= splits * vps
        assert 0 < plan.stage_vectors <= vps
        # The grid fits the co-resident capacity; every unit's blocks run
        # in one wave (block i: share i % splits of units i // splits + k * units_per_wave).
        assert plan.grid <= capacity
        seen = {}
        for block in range(plan.grid):
            for k, unit in enumerate(range(block // splits, plan.units, plan.units_per_wave)):
                seen.setdefault(unit, set()).add((k, block % splits))
        assert sorted(seen) == list(range(plan.units))
        for shares in seen.values():
            assert len({k for k, _ in shares}) == 1 and sorted(s for _, s in shares) == list(range(splits))
        assert plan.waves == max(k for shares in seen.values() for k, _ in shares) + 1
        # Staged bytes within a block's shared memory.
        inputs = 2 if backward else 1
        assert plan.staged_bytes == inputs * -(-plan.stage_vectors * vec * itemsize // 16) * 16
        assert plan.staged_bytes <= stage_bytes <= MAX_STAGED
        # The units: a (b, g) group in NCHW, an image in channels_last.
        B, C = shape[:2]
        G = min(8, C)
        assert plan.units == (B if channels_last else B * G)
        assert U * vec == (C * math.prod(shape[2:]) // (1 if channels_last else G))
        if backward and not channels_last:  # the share's planes and pieces fit the table
            plane = math.prod(shape[2:]) // vec
            assert -(-vps // plane) + 1 <= 64
            assert -(-vps // plan.piece) + 64 <= 128
        # One read exactly where the unit fits the card's shared memory.
        fits = U <= capacity * ((stage_bytes // inputs) // 16 * 16 // (vec * itemsize))
        if not (backward and not channels_last):
            assert plan.one_read == fits


@pytest.mark.parametrize(
    "shape,channels_last,backward,mode",
    [
        ((16, 32, 1024, 1024), True, False, "two passes"),  # loki level 0: 67 MB an image
        ((16, 32, 1024, 1024), False, False, "one read"),  # an 8.4 MB group
        ((8, 32, 512, 512), True, True, "two passes"),  # the train step's K6: 33.5 MB of x and ct an image
        ((8, 32, 512, 512), False, True, "one read"),
        ((8, 32, 512, 512), True, False, "one read"),  # K5 there: 16.8 MB an image
        ((64, 32, 256, 256), True, False, "one read"),
        ((256, 32, 128, 128), True, True, "one read"),
    ] + [(s, cl, bwd, "one read") for s in DISTILL for cl in (False, True) for bwd in (False, True)],
)
def test_plan_mode_on_h100(shape, channels_last, backward, mode):
    plan, _ = _plan(shape, channels_last, backward)
    assert plan.mode == mode
    if mode == "two passes":  # one unit at a time on the whole grid
        assert plan.units_per_wave == 1 and plan.grid == H100[0]


def test_plan_fills_the_card_and_keeps_shares_large():
    # Few large units: spread over the card; many small ones: a wave of
    # units with shares of at least 16 KB.
    plan, _ = _plan((16, 32, 1024, 1024), False, False)
    assert plan.grid > 0.95 * H100[0] and plan.units_per_wave == 3
    plan, _ = _plan((8, 512, 8, 8), False, False)
    assert plan.splits == 1 and plan.grid == 64
    plan, _ = _plan((8, 32, 128, 128), True, False)
    assert plan.vectors_per_split * 16 >= 16384 and plan.grid <= H100[0]


def test_channels_last_threads_keep_their_channels():
    """In channels_last thread t of a block takes vectors r0 + t + k *
    active, active = (256 // P) * P with P = C / vec vectors a pixel: its
    channels are the same in every vector, which the kernel's per-thread
    constants rely on."""
    for C, vec in ((32, 8), (24, 8), (512, 4), (16, 2), (7, 1), (1024, 4)):
        P = C // vec
        active = (256 // P) * P
        for r0 in (0, 1, 5, 997):
            for t in range(0, active, 7):
                chans = {((r0 + t + k * active) * vec) % C for k in range(5)}
                assert chans == {((r0 + t) % P) * vec}


def test_channels_last_wide_pixels_give_each_channel_one_lane():
    """Where a pixel has more than 256 vectors (P), a block runs P lanes,
    thread t the lanes t, t + 256, ...: lane u takes vectors r0 + u + k * P,
    so it keeps one channel vector, and the lanes cover every channel vector
    of the pixel once. The shared table then holds two sums of each channel,
    and the staging gives up what the table takes beyond its least size."""
    for C, vec in ((2600, 8), (261, 1), (4096, 4)):
        P = C // vec
        for r0 in (0, 3, 1000):
            owned = [((r0 + u) % P) for u in range(P)]
            assert sorted(owned) == list(range(P))
            for u in (0, 255, 256, P - 1):
                assert {(r0 + u + k * P) % P for k in range(4)} == {(r0 + u) % P}
        assert layers._table_floats(C, 8, True, vec) == max(2048, -(-2 * C // 4) * 4)
        assert layers._table_floats(C, 8, False, vec) == 2048
    assert layers._table_floats(2048, 32, True, 8) == 2048  # 256 vectors a pixel: one lane a thread
    assert layers._table_floats(2048, 2048, True, 8) == 4096  # 2 * G group sums


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(2, 16, 4, 4)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        layers.group_norm_plan(x.to("meta"), 4)
    n5, n6 = layers.group_norm.launches, layers.group_norm_bwd.launches
    y = layers.group_norm(x.requires_grad_(), torch.ones(16), torch.zeros(16), 4)
    y.sum().backward()
    assert (layers.group_norm.launches, layers.group_norm_bwd.launches) == (n5, n6)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_one_device_operation_per_call():
    """Each K5 and K6 call is one kernel: no memset, no copy (counted by
    torch.profiler in a process of its own), at the path's, the train
    step's and the distillation's shapes, both layouts; and no host
    synchronisation."""
    _card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "maze_image_processing_pipeline_tpu_torch.tools.norm_ops",
         "--shape", "8,32,512,512", "--shape", "8,32,128,128", "--shape", "8,512,8,8", "--shape", "2,32,768,768"],
        cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    cases = json.loads(out.stdout.strip().splitlines()[-1])["cases"]
    assert len(cases) == 8
    for case in cases:
        assert case["fwd"] == {k: 1 for k in case["fwd"]} and len(case["fwd"]) == 1, case
        assert case["bwd"] == {k: 1 for k in case["bwd"]} and len(case["bwd"]) == 1, case
        assert "gn_fwd_kernel" in next(iter(case["fwd"])) and "gn_bwd_kernel" in next(iter(case["bwd"])), case
    assert {c["mode_fwd"] for c in cases} == {"one read", "two passes"}
    dev = torch.device("cuda")
    x = torch.randn(8, 32, 64, 64, device=dev)
    w, b = torch.rand(32, device=dev), torch.randn(32, device=dev)
    layers._group_norm_forward(x, w, b, 8, 1e-6)  # warm: build, occupancy, counters
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, stats = layers._group_norm_forward(x, w, b, 8, 1e-6)
        layers.group_norm_bwd(x, torch.ones_like(x), w, stats, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _half_ulp(v, mantissa_bits):
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** (mantissa_bits - 16))))
    return 2.0 ** (e - mantissa_bits)


def _close_bwd(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return bool((np.abs(got - ref) <= 1e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,channels_last,dtype,mode_fwd,mode_bwd",
    [
        ((2, 32, 768, 768), True, torch.bfloat16, "two passes", "two passes"),  # 37.7 MB an image
        ((2, 32, 512, 512), True, torch.float32, "two passes", "two passes"),
        ((2, 32, 512, 512), True, torch.float16, "one read", "two passes"),
        ((8, 32, 128, 128), True, torch.bfloat16, "one read", "one read"),
        ((2, 32, 768, 768), False, torch.bfloat16, "one read", "one read"),
        ((8, 512, 8, 8), False, torch.float32, "one read", "one read"),
        ((2, 24, 7, 5), True, torch.float16, "one read", "one read"),
    ],
)
def test_cuda_modes_match_plain_and_repeat(shape, channels_last, dtype, mode_fwd, mode_bwd):
    x = _check_against_plain(shape, channels_last, dtype, 8)
    assert layers.group_norm_plan(x, 8).mode == mode_fwd
    assert layers.group_norm_plan(x, 8, backward=True).mode == mode_bwd


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype,G",
    [
        ((2, 2048, 8, 8), torch.bfloat16, 32),  # 256 vectors a pixel, the most one lane a thread takes
        ((2, 2600, 4, 4), torch.bfloat16, 8),  # 325 vectors a pixel: two lanes in some threads
        ((2, 261, 9, 7), torch.float16, 9),  # odd C: 2-byte vectors, 261 a pixel
        ((2, 4096, 4, 4), torch.float32, 64),  # 1024 vectors a pixel: four lanes a thread
    ],
)
def test_cuda_channels_last_any_width(shape, dtype, G):
    """channels_last takes any channel count: where a pixel has more
    vectors than a block has threads, each thread runs several lanes."""
    _check_against_plain(shape, True, dtype, G)


def _check_against_plain(shape, channels_last, dtype, G):
    """K5 and K6 on seeded inputs: the same bits from two calls, and the
    plain versions' results within the tolerances; returns x."""
    dev = _card()
    rng = np.random.default_rng(7)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)).to(dev, dtype)
    x = x.contiguous(memory_format=fmt)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype).contiguous(memory_format=fmt)
    C = shape[1]
    w = torch.from_numpy(rng.random(C).astype(np.float32) + 0.5).to(dev)
    b = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(dev)
    y, stats = layers._group_norm_forward(x, w, b, G, 1e-6)
    y2, stats2 = layers._group_norm_forward(x, w, b, G, 1e-6)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    torch.testing.assert_close(stats, layers.group_stats_plain(x, G), rtol=1e-5, atol=1e-5)
    ref = layers.group_norm_plain(x, w, b, G).float().cpu().numpy()
    got = y.float().cpu().numpy()
    ulp = 7 if dtype == torch.bfloat16 else 10
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= _half_ulp(ref, ulp))
    plain_stats = layers.group_stats_plain(x, G)
    dx, dw, db = layers.group_norm_bwd(x, ct, w, plain_stats, G)
    again = layers.group_norm_bwd(x, ct, w, plain_stats, G)
    assert all(torch.equal(a, r) for a, r in zip((dx, dw, db), again))
    assert dx.stride() == x.stride()
    rdx, rdw, rdb = (t.float().cpu().numpy() for t in layers.group_norm_bwd_plain(x, ct, w, plain_stats, G))
    if dtype == torch.float32:
        assert _close_bwd(dx.cpu().numpy(), rdx)
    else:
        assert np.all(np.abs(dx.float().cpu().numpy() - rdx) <= _half_ulp(rdx, ulp))
    assert _close_bwd(dw.cpu().numpy(), rdw) and _close_bwd(db.cpu().numpy(), rdb)
    return x
