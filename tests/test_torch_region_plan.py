"""The route plan of the region-measurement kernel (K7 with K3,
``ops.region_histogram.region_measure_plan``), on the CPU.

The plan replays ``layout`` and ``choose_strip`` of
``csrc/region_measure.cu`` and the launcher's limits (R < 2^15, W <= 2^16),
which refuses a route it would not choose itself. Held here: its constants
against the source; every shape a path of the port measures takes the
shared-memory route with the strip it took before the device-memory route
existed; the limits of that route (R = 3760 at loki's 1280 columns, 13,468
columns at R = 64, 17,868 for the histogram alone); and the larger R and
wider frames that take the device-memory route. The plain partials at a
row wider than 2^16 keep the row x-sum in int64, as that route does.
"""

import re
from pathlib import Path

import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf

CSRC = Path(rh.__file__).resolve().parents[1] / "csrc" / "region_measure.cu"

# (W, R, partials, intensity) -> (strip, packed histogram in shared memory):
# loki's frames and the perf lab's with R = max_regions = 64, the dense
# haul's, the threshold path's buckets (R = 2), R = 256, phase 2's edge
# widths, the partials without intensity, and the histogram alone (the
# library's regionprops).
PATH_SHAPES = {
    (1280, 64, True, True): (8, True),
    (1024, 64, True, True): (8, True),
    (2560, 64, True, True): (8, True),
    (128, 2, True, True): (16, True),
    (512, 2, True, True): (16, True),
    (640, 256, True, True): (8, False),
    (1280, 256, True, True): (4, False),
    (1, 64, True, True): (16, True),
    (37, 64, True, True): (16, True),
    (1000, 64, True, True): (8, True),
    (1277, 64, True, True): (8, True),
    (1280, 64, True, False): (8, False),
    (1000, 64, True, False): (16, False),
    (1280, 64, False, True): (8, True),
}

# C5: R and W beyond the shared-memory route.
DEVICE_SHAPES = [
    (14000, 64, True, True),
    (1280, 4096, True, True),
    (256, 40000, True, True),
    (70000, 4, True, True),
    (70000, 4, True, False),
    (1280, 1 << 15, False, True),
    (65537, 4, False, True),
    (1280, 3761, True, True),
    (2560, 3372, True, True),
]


@pytest.mark.parametrize("shape", list(PATH_SHAPES), ids=str)
def test_path_shapes_take_the_shared_route(shape):
    plan = rh.region_measure_plan(*shape)
    assert plan.route == "shared memory"
    assert (plan.strip, plan.hist_shared) == PATH_SHAPES[shape]
    assert 0 < plan.smem <= 232448


@pytest.mark.parametrize("shape", DEVICE_SHAPES, ids=str)
def test_c5_shapes_take_the_device_memory_route(shape):
    plan = rh.region_measure_plan(*shape)
    assert plan.route == "device memory"
    assert (plan.strip, plan.smem, plan.hist_shared) == (0, 0, False)


@pytest.mark.parametrize(
    "W,R,partials,last",
    [
        (1280, None, True, 3760),  # the largest R of the shared route at loki's width
        (1024, None, True, 3837),
        (2560, None, True, 3371),  # the dense haul's
        (None, 64, True, 13468),  # the widest frame at R = 64
        (None, 64, False, 17868),  # the histogram alone
    ],
)
def test_the_shared_route_ends_where_no_strip_fits(W, R, partials, last):
    """The last shape of the shared route and the first of the other, along
    R at a fixed width or along W at a fixed R."""
    def shape(v):
        return (W, v) if R is None else (v, R)

    assert rh.region_measure_plan(*shape(last), partials, True).route == "shared memory"
    assert rh.region_measure_plan(*shape(last + 1), partials, True).route == "device memory"
    assert rh.region_measure_plan(*shape(last), partials, True).strip == 1


def test_the_launcher_limits_hold_whatever_fits():
    """R >= 2^15 or W > 2^16 take the device-memory route even where a strip
    would fit (the histogram alone's layout does not grow with R)."""
    assert rh.region_measure_plan(64, (1 << 15) - 1, False, True).route == "shared memory"
    assert rh.region_measure_plan(64, 1 << 15, False, True).route == "device memory"
    assert rh.region_measure_plan(1 << 16, 1, False, True).route == "device memory"  # no strip fits either
    assert rh.region_measure_plan((1 << 16) + 1, 1, False, True).route == "device memory"


def test_plan_constants_follow_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1).split("//")[0].strip()

    assert eval(const("kTwoBlocks")) == rh._TWO_BLOCKS
    assert eval(const("kOneBlock")) == rh._ONE_BLOCK
    assert eval(const("kHistShared")) == rh._HIST_SHARED
    assert eval(const("kPacked")) == rh._PACKED
    assert eval(const("kRowIxMaxW")) == rh._ROW_IX_MAX_W
    assert eval(const("kGlobalMaxW")) == rh._MAX_W == 1 << 16
    assert "const int two[] = {16, 8, 4}, one[] = {16, 8, 4, 2, 1};" in src
    assert "R < (1 << 15) && W <= (1 << 16) ? choose_strip(a, P, I) : 0" in src
    assert rh._MAX_R == 1 << 15
    assert "a.lab_slot = round16(4 * static_cast<size_t>(W) + 32);" in src
    assert "a.img_slot = round16(static_cast<size_t>(W) + 32);" in src
    # The layout's terms, in the order the plan adds them.
    for term in ("off += TH * a.img_slot", "round16(3 * R * sizeof(unsigned long long))",
                 "R * 128 * sizeof(unsigned)", "round16((I ? 5 + a.row_ix : 4) * TH * R * sizeof(int32_t))",
                 "round16(static_cast<size_t>(a.W) * sizeof(unsigned))", "round16(2 * R * sizeof(unsigned))"):
        assert term in src, term


@pytest.mark.parametrize("W", [64, 1280, 5000, 20000])
@pytest.mark.parametrize("R", [1, 2, 64, 97, 256, 3000])
@pytest.mark.parametrize("partials,intensity", [(True, True), (True, False), (False, True)])
def test_plan_takes_the_tallest_strip_that_fits(W, R, partials, intensity):
    """The plan's strip is the first of 16, 8, 4 rows within two blocks an
    SM, else of 16 ... 1 within one, with the packed histogram wherever R's
    table fits its budget and the strip holds at most 65535 pixels; none
    fits: the device-memory route."""
    def fits(th, budget, hist):
        return rh.measure_layout(W, R, th, partials, intensity, hist) <= budget and not (hist and th * W > 65535)

    order = [(th, 112 * 1024) for th in (16, 8, 4)] + [(th, 232448) for th in (16, 8, 4, 2, 1)]
    hist_options = [True, False] if intensity and R <= 96 else [False]
    want = next(((th, h) for h in hist_options for th, b in order if fits(th, b, h)), (0, False))
    plan = rh.region_measure_plan(W, R, partials, intensity)
    assert (plan.strip, plan.hist_shared) == want
    if plan.strip:
        assert plan.smem == rh.measure_layout(W, R, plan.strip, partials, intensity, plan.hist_shared)


def test_plain_partials_keep_wide_row_sums_in_int64():
    """A row of 70,000 columns: its x-sum passes 2^31, so the plain partials
    (the device-memory route's oracle) give it as int64, exact."""
    W = 70000
    lab = torch.zeros((1, 2, W), dtype=torch.int32)
    lab[0, 1, 100:200] = 3
    lab[0, 1, -5:] = 1
    sums, rowcnt, rowsumx, rowminx, rowmaxx, colcnt = rf.region_props_partials_plain(lab, None, 4)
    assert rowsumx.dtype == torch.int64 and rowcnt.dtype == torch.int32
    assert int(rowsumx[0, 0, 0]) == W * (W - 1) // 2 > 2**31
    assert int(rowsumx[0, 1, 3]) == sum(range(100, 200))
    assert int(rowsumx[0, 1, 1]) == sum(range(W - 5, W))
    assert (int(rowminx[0, 1, 3]), int(rowmaxx[0, 1, 3]), int(rowminx[0, 0, 3])) == (100, 199, W)
    assert int(colcnt[0, 150, 3]) == 1 and int(colcnt[0, 150, 0]) == 1
    narrow = rf.region_props_partials_plain(lab[..., : 1 << 16].contiguous(), None, 4)
    assert narrow[2].dtype == torch.int32 and int(narrow[2][0, 1, 3]) == int(rowsumx[0, 1, 3])
