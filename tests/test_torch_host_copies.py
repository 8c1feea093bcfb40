"""The port's copies of host (numpy) code stay equal to their originals.

The port imports nothing of the JAX package, so the host modules it needs
are its own copies: the engine (``engine/core.py`` ... ``tiles.py``),
``dataio/``, ``common.py``, ``config.py``, ``progress.py``,
``loki/{meta,zoomie}.py``, ``polytaxo/``, the image nodes of
``engine/image.py``, ``ops/host_props.py``, ``ops/zooprocess.py``,
``rescale_max_intensity``, the host functions of ``predict/pipeline.py``,
and the host code of ``BatchedImageProperties`` (chunking, host fallback)
and of the full-frame debug archive. Each copy must hold the original's
code (only docstrings and imports differ), and the same inputs go through
original and copy with identical outputs. The last test holds the port's
entry points to the card: asked for no device, they raise without one.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.dataio import ecotaxa as j_ecotaxa
from maze_image_processing_pipeline_tpu.engine import image as j_image
from maze_image_processing_pipeline_tpu.loki import meta as j_meta
from maze_image_processing_pipeline_tpu.loki import zoomie as j_zoomie
from maze_image_processing_pipeline_tpu.loki.pipeline import score_fn_simple
from maze_image_processing_pipeline_tpu.ops import host_props as j_host_props
from maze_image_processing_pipeline_tpu.ops import zooprocess as j_zoo
from maze_image_processing_pipeline_tpu.ops.image import rescale_max_intensity as j_rescale
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.dataio import ecotaxa as t_ecotaxa
from maze_image_processing_pipeline_tpu_torch.engine import image as t_image
from maze_image_processing_pipeline_tpu_torch.loki import device_seg as t_seg
from maze_image_processing_pipeline_tpu_torch.loki import meta as t_meta
from maze_image_processing_pipeline_tpu_torch.loki import pipeline as t_pipeline
from maze_image_processing_pipeline_tpu_torch.loki import zoomie as t_zoomie
from maze_image_processing_pipeline_tpu_torch.ops import host_props as t_host_props
from maze_image_processing_pipeline_tpu_torch.ops import merge_labels as t_merge
from maze_image_processing_pipeline_tpu_torch.ops import zooprocess as t_zoo
from maze_image_processing_pipeline_tpu_torch.ops.image import rescale_max_intensity as t_rescale


def _scene(seed=0, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    m = ndi.binary_dilation(rng.random(shape) < 0.01, iterations=3)
    m[25:35, 30:50] = True
    m[29:31, 38:42] = False  # a hole
    labels, n = ndi.label(m, structure=np.ones((3, 3)))
    image = rng.integers(0, 256, shape).astype(np.uint8)
    return labels.astype(np.int32), n, image


def _assert_same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_region_props_copy(seed):
    labels, n, image = _scene(seed)
    for r in range(1, n + 1):
        mask = labels == r
        for inten in (image, None):
            _assert_same(
                t_host_props.host_region_props(mask, inten),
                j_host_props.host_region_props(mask, inten),
            )


def test_zooprocess_copy():
    labels, n, image = _scene(2)
    props = j_host_props.host_region_props(labels == 1, image)
    for area_filled in (None, float(props["area"][1]) + 4.0):
        _assert_same(
            t_zoo.zooprocess_features(props, 1, area_filled=area_filled, prefix="object_"),
            j_zoo.zooprocess_features(props, 1, area_filled=area_filled, prefix="object_"),
        )
    assert t_zoo.N_FEATURES == j_zoo.N_FEATURES


def _run_nodes(mod, frames, alpha, keep_background, bg_color, padding, min_area):
    engine = t_engine if mod is t_image else j_engine
    out = []
    with engine.Pipeline() as p:
        labels, image = engine.Unpack(frames).unpack(2)
        region = mod.FindRegions(labels, image, padding=padding, min_area=min_area)
        roi = mod.ExtractROI(
            image, region, alpha=alpha, bg_color=bg_color,
            keep_background=keep_background, labels=labels,
        )
        meta = mod.CalculateZooProcessFeatures(region, {"k": 1}, prefix="object_")
        engine.Call(lambda r, o, m: out.append((r, o, m)), region, roi, meta)
    p.run()
    return out


@pytest.mark.parametrize(
    "alpha,keep_background,bg_color",
    [(0, True, 0), (1, True, "white"), (1, False, "quantile:0.25")],
)
def test_image_nodes_copy(alpha, keep_background, bg_color):
    frames = [_scene(s)[::2] for s in (3, 4)]
    ref = _run_nodes(j_image, frames, alpha, keep_background, bg_color, padding=4, min_area=5)
    ours = _run_nodes(t_image, frames, alpha, keep_background, bg_color, padding=4, min_area=5)
    assert len(ours) == len(ref) > 2
    for (rr, ro, rm), (tr, to, tm) in zip(ref, ours):
        assert isinstance(tr, t_image.RegionInfo)
        for slot in j_image.RegionInfo.__slots__:
            _assert_same(getattr(tr, slot), getattr(rr, slot))
        _assert_same(to, ro)
        _assert_same(tm, rm)


def test_region_info_slots_match():
    assert t_image.RegionInfo.__slots__ == j_image.RegionInfo.__slots__
    r = t_image.RegionInfo(1, (0, 0, 2, 2), (0, 0, 2, 2), np.ones((2, 2), bool), None, {"area": 4.0}, 4.0)
    assert r.area == 4.0 and r.other_mask is None


# -- the host layer's copies (engine, dataio, loki, common, config) ----------

REPO = Path(__file__).resolve().parent.parent
COPIES = [
    "engine/core.py", "engine/stream.py", "engine/pipelines.py", "engine/batch.py",
    "engine/stitch.py", "engine/tiles.py", "common.py", "loki/meta.py", "loki/zoomie.py",
    "dataio/archive.py", "dataio/ecotaxa.py", "dataio/imageio.py", "dataio/loki.py",
    "dataio/telemetry.py", "config.py", "progress.py", "_version.py",
    "polytaxo/__init__.py", "polytaxo/core.py",
]


def _code(path: Path) -> str:
    """The module's code without its docstring and import statements."""
    body = ast.parse(path.read_text()).body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module([n for n in body if not isinstance(n, (ast.Import, ast.ImportFrom))], []))


@pytest.mark.parametrize("rel", COPIES)
def test_host_module_copy_has_the_original_code(rel):
    original = REPO / "maze_image_processing_pipeline_tpu" / rel
    copy = REPO / "maze_image_processing_pipeline_tpu_torch" / rel
    assert _code(copy) == _code(original)
    assert f"maze_image_processing_pipeline_tpu/{rel}" in ast.get_docstring(ast.parse(copy.read_text()))


# Host functions of predict/pipeline.py that the port's pipeline copies.
PREDICT_COPIES = ["_convex_area", "measure_segments", "_prepare_translation", "build_polytaxo_pipeline"]


def _function_of(body, name: str) -> str:
    """The code of the function ``name`` of ``body`` without its docstring."""
    (fn,) = [n for n in body if isinstance(n, ast.FunctionDef) and n.name == name]
    if fn.body and isinstance(fn.body[0], ast.Expr) and isinstance(fn.body[0].value, ast.Constant):
        fn.body = fn.body[1:]
    return ast.dump(fn)


def _function(path: Path, name: str) -> str:
    """The module-level function's code without its docstring."""
    return _function_of(ast.parse(path.read_text()).body, name)


@pytest.mark.parametrize("name", PREDICT_COPIES)
def test_predict_host_function_copy_has_the_original_code(name):
    rel = "predict/pipeline.py"
    original = REPO / "maze_image_processing_pipeline_tpu" / rel
    copy = REPO / "maze_image_processing_pipeline_tpu_torch" / rel
    assert _function(copy, name) == _function(original, name)


def _method(path: Path, cls: str, name: str) -> str:
    """The method's code without its docstring."""
    (c,) = [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.ClassDef) and n.name == cls]
    return _function_of(c.body, name)


# Host code of the threshold path and of the label-frame paths that the port
# copies: (module, class or None, function).
HOST_CODE_COPIES = [
    ("engine/image.py", "BatchedImageProperties", "transform_stream"),
    ("engine/image.py", "BatchedImageProperties", "_host"),
    ("engine/image.py", "BatchedImageProperties", "_input_names"),
    ("loki/device_seg.py", None, "_build_full_frame_debug_output"),
]


@pytest.mark.parametrize("rel,cls,name", HOST_CODE_COPIES)
def test_threshold_and_label_frame_host_code_copies(rel, cls, name):
    original = REPO / "maze_image_processing_pipeline_tpu" / rel
    copy = REPO / "maze_image_processing_pipeline_tpu_torch" / rel
    if cls is None:
        assert _function(copy, name) == _function(original, name)
    else:
        assert _method(copy, cls, name) == _method(original, cls, name)


def test_polytaxo_copy_decodes_like_the_original():
    import yaml

    from maze_image_processing_pipeline_tpu import polytaxo as j_poly
    from maze_image_processing_pipeline_tpu_torch import polytaxo as t_poly

    import chip_smoke

    tree = yaml.safe_load(chip_smoke.TAXONOMY_YAML)
    jt, tt = j_poly.PolyTaxonomy.from_dict(tree), t_poly.PolyTaxonomy.from_dict(tree)
    assert tt.format_tree() == jt.format_tree()
    rng = np.random.default_rng(4)
    for probs in rng.random((20, 4)):
        for thr in (0.6, 0.9):
            a = jt.parse_probabilities(probs, thr_pos_abs=thr, thr_neg=1 - thr)
            b = tt.parse_probabilities(probs, thr_pos_abs=thr, thr_neg=1 - thr)
            assert str(b) == str(a)
    for expr in ("Calanoida", "!oil-sack", "Copepoda oil-sack"):
        assert str(tt.parse_expression(expr)) == str(jt.parse_expression(expr))


def _stream_run(engine, items):
    """Stitch crops into frames, drop one frame, cap the count, buffer."""
    out = []
    with engine.Pipeline() as p:
        crop, frame, y, x = engine.Unpack(items).unpack(4)
        engine.StreamBuffer(2)
        img = engine.Stitch(crop, groupby=frame, offset=(y, x))
        engine.Filter(engine.Call(lambda f: f != "f1", frame))
        engine.Slice(3)
        engine.Call(lambda f, i: out.append((f, np.asarray(i).copy(), i.n_regions)), frame, img)
    p.run()
    return out


def test_engine_copy_runs_a_pipeline_like_the_original():
    rng = np.random.default_rng(0)
    items = [
        ((rng.random((6, 8)) * 255).astype(np.uint8), f"f{f}", int(rng.integers(0, 20)), int(rng.integers(0, 20)))
        for f in range(5)
        for _ in range(int(rng.integers(1, 4)))
    ]
    ref, ours = _stream_run(j_engine, items), _stream_run(t_engine, items)
    assert [f for f, *_ in ours] == [f for f, *_ in ref] == ["f0", "f2", "f3"]
    for (_, ri, rn), (_, oi, on) in zip(ref, ours):
        np.testing.assert_array_equal(oi, ri)
        assert on == rn


def test_object_ids_and_tsv_copies(tmp_path):
    meta = {"object_date": "20220103", "object_time": "120102", "object_milliseconds": 333,
            "object_sequence": 7, "object_posx": 12, "object_posy": 345}
    oid = j_meta.format_object_id(meta)
    assert t_meta.format_object_id(meta) == oid
    assert t_meta.parse_object_id(oid, {"a": 1}) == j_meta.parse_object_id(oid, {"a": 1})
    df = pd.DataFrame({"object_id": [oid, oid + "x"], "object_area": [1.5, 2.0], "img_rank": [0, 1]})
    for mod, name in ((j_ecotaxa, "j.tsv"), (t_ecotaxa, "t.tsv")):
        mod.write_tsv(df, str(tmp_path / name))
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    pd.testing.assert_frame_equal(t_ecotaxa.read_tsv(str(tmp_path / "j.tsv")), j_ecotaxa.read_tsv(str(tmp_path / "j.tsv")))


def _dedup_run(engine, zoomie, metas):
    out = []
    with engine.Pipeline() as p:
        m = engine.Unpack(metas)
        dup = zoomie.DetectDuplicatesSimple(
            engine.Call(lambda x: x["object_frame_id"], m), engine.Call(lambda x: x["object_id"], m),
            score_fn=score_fn_simple, score_arg=m, min_similarity=0.5, max_age=1,
        )
        engine.Call(lambda d: out.append(d), dup)
    p.run()
    return out


def test_detect_duplicates_copy():
    rng = np.random.default_rng(1)
    metas = []
    for f in range(4):
        for k in range(3):
            jitter = int(rng.integers(0, 4)) if f % 2 else 0
            metas.append({"object_frame_id": f"f{f}", "object_id": f"f{f}o{k}",
                          "object_posx": 50 * k + jitter, "object_posy": 10, "object_width": 30, "object_height": 20})
    ref = _dedup_run(j_engine, j_zoomie, metas)
    ours = _dedup_run(t_engine, t_zoomie, metas)
    assert ours == ref and len(set(ref)) < len(ref)  # some objects were matched


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_rescale_max_intensity_copy(dtype):
    img = (np.random.default_rng(2).random((9, 11)) * 100).astype(dtype)
    for x in (img, np.zeros_like(img)):
        out = t_rescale(x)
        np.testing.assert_array_equal(out, j_rescale(x))
        assert out.dtype == x.dtype


def _scalebar_filter_run(engine, image_mod, images, metas):
    out = []
    with engine.Pipeline() as p:
        img, meta = engine.Unpack(list(zip(images, metas))).unpack(2)
        image_mod.FilterEval("object_area > 3 and object_kind != 'skip'", meta)
        bar = image_mod.DrawScalebar(img, length_in_unit=1, px_per_unit=20, unit="mm", fg_color=255, bg_color=0)
        engine.Call(lambda b, m: out.append((b, m["object_area"])), bar, meta)
    p.run()
    return out


def test_draw_scalebar_and_filter_eval_copies():
    rng = np.random.default_rng(3)
    images = [(rng.random((10 + 5 * i, 14)) * 255).astype(np.uint8) for i in range(4)]
    metas = [{"object_area": a, "object_kind": k} for a, k in ((5, "a"), (2, "a"), (9, "skip"), (4, "b"))]
    ref = _scalebar_filter_run(j_engine, j_image, images, metas)
    ours = _scalebar_filter_run(t_engine, t_image, images, metas)
    assert [a for _, a in ours] == [a for _, a in ref] == [5, 4]
    for (rb, _), (ob, _) in zip(ref, ours):
        np.testing.assert_array_equal(ob, rb)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Asked for nothing, the port runs on the card; with no card it raises
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_seg.DeviceTiledSegmentation(None, None, None, t_seg.DEFAULT_POSTPROCESS)
    cfg = SimpleNamespace(device_blend=True, full_frame_archive_fn=None)
    with t_engine.Pipeline():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_seg.build_torch_segmentation(cfg, "", t_engine.Unpack([]), t_engine.Unpack([]), {})
    task = {
        "input": {"path": str(tmp_path / "none")},
        "segmentation": {"jax": {"model_fn": str(tmp_path / "model")}},
        "postprocess": {},
        "output": {"target_dir": str(tmp_path / "out")},
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_pipeline.Runner._configure_and_run(task)
    # The threshold measurement, the host-blend frame chain and segment
    # merging.
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_image.BatchedImageProperties(None, 50)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_seg.DeviceFramePostprocess(None, None, t_seg.DEFAULT_POSTPROCESS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_merge.merge_labels(np.zeros((4, 4), np.int32))


# -- the parallel section's copies -------------------------------------------


def _class(path: Path, name: str) -> str:
    """The class's code."""
    (c,) = [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.ClassDef) and n.name == name]
    return ast.dump(c)


def test_parallel_config_and_partition_work_are_copies():
    """``ParallelConfig`` (the ``parallel:`` section, field for field) and
    ``partition_work`` hold the originals' code, and give the same outputs."""
    from maze_image_processing_pipeline_tpu import parallel as jp
    from maze_image_processing_pipeline_tpu_torch import parallel as tp

    rel = "parallel/config.py"
    assert _class(REPO / "maze_image_processing_pipeline_tpu_torch" / rel, "ParallelConfig") == _class(
        REPO / "maze_image_processing_pipeline_tpu" / rel, "ParallelConfig")
    assert f"maze_image_processing_pipeline_tpu/{rel}" in ast.get_docstring(
        ast.parse((REPO / "maze_image_processing_pipeline_tpu_torch" / rel).read_text()))
    rel = "parallel/multihost.py"
    assert _function(REPO / "maze_image_processing_pipeline_tpu_torch" / rel, "partition_work") == _function(
        REPO / "maze_image_processing_pipeline_tpu" / rel, "partition_work")
    for section in (True, {"mesh": {"data": 4, "model": 2}, "data_axis": "data"},
                    {"coordinator_address": "h:1", "num_processes": 2, "process_id": 1}):
        assert tp.ParallelConfig.model_validate(section).model_dump() == \
            jp.ParallelConfig.model_validate(section).model_dump()
    items = list(range(11))
    for n in (1, 2, 3):
        assert [tp.partition_work(items, n, i) for i in range(n)] == [jp.partition_work(items, n, i) for i in range(n)]
    for bad in (-1, 3):
        with pytest.raises(ValueError, match=rf"host {bad} not in \[0, 3\)"):
            tp.partition_work(items, 3, bad)
    assert tp.partition_work(items) == jp.partition_work(items, 1, 0)


def test_make_mesh_checks_are_the_originals():
    """``make_mesh``'s argument checks and defaults, ``shard_batch_spec`` and
    ``shard_params``' rule (``model_split``), against the JAX package's on
    the same number of devices."""
    import jax

    from maze_image_processing_pipeline_tpu.parallel import mesh as jm
    from maze_image_processing_pipeline_tpu_torch.parallel import mesh as tm

    cpu = torch.device("cpu")
    for n, axes in ((2, {"data": 3}), (4, {"data": 2}), (8, {"data": 4, "model": 3})):
        with pytest.raises(ValueError) as j_err:
            jm.make_mesh(axes, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as t_err:
            tm.make_mesh(axes, devices=[cpu] * n)
        assert str(t_err.value) == str(j_err.value)
    for n, axes in ((2, None), (8, {"data": 4, "model": 2}), (8, {"data": 2, "space": 2, "model": 2}),
                    (4, {"space": 4})):
        j_mesh, t_mesh = jm.make_mesh(axes, devices=jax.devices()[:n]), tm.make_mesh(axes, devices=[cpu] * n)
        assert t_mesh.axis_names == j_mesh.axis_names and t_mesh.devices.shape == j_mesh.devices.shape
        for ndim in (2, 3, 4):
            assert tm.shard_batch_spec(t_mesh, ndim) == tuple(jm.shard_batch_spec(j_mesh, ndim))
    # shard_params' rule: which arrays the JAX package splits over a model
    # axis of 2 (its kernels' output channels last, the port's first).
    j_mesh = jm.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    for shape in ((3, 3, 3, 64), (3, 3, 64, 128), (3, 3, 64, 32), (1, 1, 64, 2), (64,), (128,), (2, 2, 8, 66),
                  (3, 3, 4, 63), (32, 64)):
        placed = jm.shard_params({"a": np.zeros(shape, np.float32)}, j_mesh)["a"]
        split = placed.sharding.spec != jax.sharding.PartitionSpec()
        port_shape = (shape[-1],) + tuple(shape[:-1])
        assert tm.model_split(port_shape, 2) == split, shape
