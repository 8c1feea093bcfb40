"""Several devices in the PyTorch port (``parallel/``), against the JAX package.

On the CPU a port mesh is made of replicas of the CPU device; the JAX
package runs on the 8 virtual CPU devices of ``tests/conftest.py``. At
``tests/test_parallel_e2e.py``'s size (4 frames of 180×230, tiles 128 / 96):

* the port's loki Runner with ``parallel: {mesh: {data: 4, model: 2}}`` gives
  the archive of the JAX Runner with the same section, and of its own run
  without ``parallel`` (the device path and the host-blend path);
* ``TorchInference`` and ``DeviceTiledInference`` over a 2-replica mesh
  equal the port's nodes without a mesh within 1e-6, as
  ``test_parallel_e2e.py`` holds the JAX nodes' mesh against one device,
  and the JAX nodes over a ``{data: 2}`` mesh within the tolerance
  ``test_torch_predict_inference.py`` holds the two packages' nodes to
  (rtol 1e-4 / atol 2e-5: float32 convolutions of two frameworks);
* the mesh train step on 2 replicas equals the one-device step on the whole
  batch and the JAX step with ``mesh={data: 2}``, on the same weights
  (``params_from_jax``), within rtol 1e-5 (loss and parameters); a U-Net
  that ``model`` splits is sharded instead (``test_torch_sharding.py``
  holds that step);
* two ``gloo`` processes joined by ``initialize_distributed`` see ranks 0
  and 1 of 2, and the union of their ``num_shards: 2`` archives equals the
  unsharded run;
* the mesh's checks: ``make_mesh()`` without a card raises, axes that do not
  cover the devices raise, ``setup_parallel`` builds CPU meshes for a
  ``device: cpu`` task.

The archives are compared by ``chip_smoke.compare_archives`` (floats within
rtol 1e-5 / atol 1e-3; the columns that name the run left out).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from fixtures import draw_blob, make_loki_sample
from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.loki.pipeline import Runner as JaxRunner
from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.models import train as j_train
from maze_image_processing_pipeline_tpu.models.inference import DeviceTiledInference as JaxTiled
from maze_image_processing_pipeline_tpu.models.inference import JaxInference
from maze_image_processing_pipeline_tpu.models.unet import UNet as JaxUNet
from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch import parallel as tp
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as TorchRunner
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models import train as t_train
from maze_image_processing_pipeline_tpu_torch.models.inference import DeviceTiledInference, TorchInference
from maze_image_processing_pipeline_tpu_torch.models.unet import ShardedUNet
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet as TorchUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = "LOKI_PS122-1_7.zip"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("haul")
    make_loki_sample(str(root / "data"), n_frames=4, objects_per_frame=3, frame_shape=(180, 230))
    chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    return root


def _task(data, model_fn, target_dir, parallel=False, **seg):
    return {
        "input": {"path": str(data)},
        "segmentation": {
            "jax": {
                "model_fn": model_fn,
                "device": "cpu",
                "dtype": "float32",
                "batch_size": 4,
                "tile_size": 128,
                "tile_stride": 96,
                "stitch": True,
                "postprocess": {"closing_radius": 2, "min_area": 20, "max_regions": 16},
                "padding": 10,
                **seg,
            }
        },
        "postprocess": {},
        "output": {"target_dir": str(target_dir), "store_mask": True},
        "parallel": parallel,
    }


@pytest.mark.parametrize("blend", ["device", "host"])
def test_loki_runner_on_a_mesh_matches_jax_and_one_device(haul, blend):
    """The device path round-robins frame groups (``frame_batch: 2``: two
    groups) over the mesh's 8 replicas; the host-blend path splits
    ``TorchInference``'s batches over them and round-robins the frames of
    ``DeviceFramePostprocess``."""
    seg = {"frame_batch": 2} if blend == "device" else {"device_blend": False}
    parallel = {"mesh": {"data": 4, "model": 2}}
    JaxRunner._configure_and_run(_task(haul / "data", str(haul / "unet"), haul / f"jax_{blend}", parallel, **seg))
    TorchRunner._configure_and_run(_task(haul / "data", str(haul / "unet"), haul / f"mesh_{blend}", parallel, **seg))
    TorchRunner._configure_and_run(_task(haul / "data", str(haul / "unet"), haul / f"one_{blend}", **seg))
    ref = str(haul / f"jax_{blend}" / ARCHIVE)
    n = chip_smoke.compare_archives(ref, str(haul / f"mesh_{blend}" / ARCHIVE))
    m = chip_smoke.compare_archives(str(haul / f"one_{blend}" / ARCHIVE), str(haul / f"mesh_{blend}" / ARCHIVE))
    assert n == m >= 4


def _unet_pair(tmp_path, cfg, seed):
    """A float32 UNet written by the port and read by both packages."""
    path = chip_smoke.write_unet(str(tmp_path / "unet"), cfg, "float32", seed=seed, channel_names=("a", "b"))
    return j_model_io.load_model(path, dtype="float32"), t_model_io.load_model(path, dtype="float32")


def _run_nodes(engine, make_node, items):
    out = []
    with engine.Pipeline() as p:
        img = engine.Unpack(items)
        pred = make_node(img)
        engine.Call(lambda v: out.append(np.asarray(v, np.float32)), pred)
    p.run()
    return out


def test_inference_nodes_on_a_two_replica_mesh_match_jax(tmp_path):
    """``TorchInference`` (7 crops in batches of 3: padded to 4 for the
    mesh, each batch split over the replicas) and ``DeviceTiledInference``
    (tiles 64 / 48, batch 3, each bucket's objects split over the replicas)
    over two CPU replicas: the port without a mesh within 1e-6, the JAX nodes
    over ``{data: 2}`` within rtol 1e-4 / atol 2e-5."""
    jm, tm = _unet_pair(tmp_path, dict(out_channels=2, base_features=4, depth=1), seed=2)
    j_mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
    t_mesh = tp.make_mesh({"data": 2}, devices=[CPU, CPU])
    rng = np.random.default_rng(3)
    crops = [draw_blob(rng, shape=(32, 32), r=8) for _ in range(7)]
    tiles = [draw_blob(rng, shape=s, r=10) for s in [(64, 64), (100, 90), (40, 56)]]
    for name, items, jax_node, node in (
        ("TorchInference", crops, lambda img: JaxInference(jm, img, batch_size=3, mesh=j_mesh),
         lambda img, mesh: TorchInference(tm, img, batch_size=3, mesh=mesh, device="cpu")),
        ("DeviceTiledInference", tiles,
         lambda img: JaxTiled(jm, img, tile_size=64, tile_stride=48, batch_size=3, mesh=j_mesh)[0],
         lambda img, mesh: DeviceTiledInference(tm, img, tile_size=64, tile_stride=48, batch_size=3, mesh=mesh,
                                                device="cpu")[0]),
    ):
        ref = _run_nodes(j_engine, jax_node, items)
        ours = _run_nodes(t_engine, lambda img: node(img, t_mesh), items)
        one = _run_nodes(t_engine, lambda img: node(img, None), items)
        assert [a.shape for a in ours] == [b.shape for b in ref] == [c.shape for c in one], name
        for a, b, c in zip(ours, ref, one):
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5, err_msg=name)


def test_mesh_train_step_matches_one_device_and_jax():
    """``UNet(2, 8, 2)`` float32, a batch of 4 of 32², AdamW 1e-3, one step
    from the JAX initial parameters: the port's step on two CPU replicas,
    its one-device step and the JAX step with ``mesh={data: 2}``. The loss
    within rtol 1e-5; the summed gradients within
    ``test_torch_train.py``'s tolerance of JAX's (1e-4 of the tensor's norm
    plus 1e-6 of the whole gradient's) and of the one-device step's; the
    parameters after the step within rtol 1e-5 wherever the reference's
    gradient exceeds 1e-2 of its tensor's norm plus 1e-6 of the whole
    gradient's. AdamW's first step moves every element by about lr times
    the sign of its gradient, so an element whose gradient is smaller may
    move the other way on float noise: JAX's own jitted step and its eager
    gradient disagree in sign on elements up to 2.75e-3 of their tensor's
    norm here (a GroupNorm scale's gradient is a sum of large terms that
    cancel), and the conv biases that feed a GroupNorm have an analytically
    zero gradient. Those elements are held within 2 lr."""
    cfg = dict(out_channels=2, base_features=8, depth=2)
    rng = np.random.default_rng(7)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)
    y = (rng.random((4, 32, 32, 2)) > 0.5).astype(np.float32)

    j_mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
    j_module = JaxUNet(**cfg, dtype=jnp.float32)
    j_state, j_opt = j_train.create_train_state(j_module, jax.random.key(0), (4, 32, 32, 3), mesh=j_mesh)
    init = jax.tree.map(np.asarray, j_state.params)
    j_grads = t_model_io.params_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: j_train.bce_dice_loss(j_module.apply(p, x), y))(j_state.params)))
    j_state, m = j_train.make_train_step(j_module, j_opt, mesh=j_mesh)(j_state, x, y)
    j_loss = float(m["loss"])
    j_params = t_model_io.params_from_jax(jax.tree.map(np.asarray, j_state.params))
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in j_grads.values()))
    lr = 1e-3

    runs = {}
    for name, mesh in (("one", None), ("mesh", tp.make_mesh({"data": 2}, devices=[CPU, CPU]))):
        module = TorchUNet(**cfg, dtype="float32")
        state, opt = t_train.create_train_state(module, (4, 32, 32, 3), device="cpu", mesh=mesh)
        module.load_state_dict(t_model_io.params_from_jax(init))
        state, m = t_train.make_train_step(module, opt, mesh=mesh)(state, x, y)
        assert state.step == 1
        runs[name] = (float(m["loss"]), {k: p.grad.clone() for k, p in module.named_parameters()},
                      {k: v.detach().clone() for k, v in module.state_dict().items()})
    loss, grads, params = runs["mesh"]
    for ref_loss, ref_grads, ref_params in ((j_loss, j_grads, j_params), runs["one"]):
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k, g in grads.items():
            tol = 1e-4 * float(ref_grads[k].norm()) + 1e-6 * total
            err = float((g - ref_grads[k]).abs().max())
            assert err <= tol, (k, err)
            sure = ref_grads[k].abs() > 1e-2 * float(ref_grads[k].norm()) + 1e-6 * total
            diff = (params[k] - ref_params[k]).abs()
            np.testing.assert_allclose(params[k][sure].numpy(), ref_params[k][sure].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            assert float(diff[~sure].max()) <= 2 * lr * (1 + 1e-5) if bool((~sure).any()) else True, k
        assert sorted(params) == sorted(ref_params)
    assert optax  # the JAX step's optimizer


@pytest.mark.parametrize("width", [4, 64])
def test_mesh_train_step_checks_the_batch_and_the_placement(width):
    """``{data: 2, model: 2}``: a U-Net of no conv 64 wide stays a replica on
    every card (the step splits the batch alone); ``UNet(1, 64, 1)`` is
    sharded, each card holding half the output channels of its wide convs
    and the narrow head whole. Either checks the batch against the data
    axis."""
    cfg = dict(out_channels=1, base_features=width, depth=1)
    mesh = tp.make_mesh({"data": 2, "model": 2}, devices=[CPU] * 4)
    module = TorchUNet(**cfg, dtype="float32")
    state, opt = t_train.create_train_state(module, (2, 16, 16, 3), mesh=mesh)
    if width == 4:
        assert state.module is module and next(module.parameters()).device == CPU
    else:
        assert isinstance(state.module, ShardedUNet) and state.module.groups == 2
        for (d, s, m), held in state.module.params.items():
            assert held["ConvBlock_0.Conv_0.weight"].shape == (32, 3, 3, 3)
            assert held["ConvBlock_1.Conv_1.weight"].shape == (64, 128, 3, 3)
            assert held["Conv_1.weight"].shape == (1, 64, 1, 1)
        assert len(opt.param_groups[0]["params"]) == len(state.module.parameters())
    step = t_train.make_train_step(module, opt, mesh=mesh)
    x = np.zeros((3, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="data axis of 2"):
        step(state, x, x[..., :1])
    # Two samples over the mesh: a share of one each (over four replicas,
    # two shares empty).
    state, m = step(state, x[:2], x[:2, ..., :1])
    assert np.isfinite(float(m["loss"])) and state.step == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SHARD_SCRIPT = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {repo!r})
    rank, task = int(sys.argv[1]), json.loads(sys.argv[2])
    from maze_image_processing_pipeline_tpu_torch.parallel import host_count, host_id, initialize_distributed
    from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner
    initialize_distributed({address!r}, 2, rank, device="cpu")
    task["output"]["target_dir"] += str(host_id())
    task["input"].update(num_shards=host_count(), shard_index=host_id())
    Runner._configure_and_run(task)
    print(json.dumps({{"rank": host_id(), "world": host_count()}}))
    """
)


def test_two_gloo_processes_shard_the_samples(tmp_path):
    """Two processes joined by ``initialize_distributed`` (gloo, a local
    TCP coordinator) take ``num_shards: 2`` each by its rank: the union of
    their archives equals the unsharded run's (two samples)."""
    data = tmp_path / "multi"
    make_loki_sample(str(data), name="LOKI_00001.01", n_frames=2, objects_per_frame=3, frame_shape=(180, 230),
                     haul="7")
    make_loki_sample(str(data), name="LOKI_00002.01", n_frames=2, objects_per_frame=3, frame_shape=(180, 230),
                     haul="8", seed=1)
    unet = chip_smoke.write_unet(str(tmp_path / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    script = SHARD_SCRIPT.format(repo=REPO, address=f"127.0.0.1:{_free_port()}")
    task = json.dumps(_task(data, unet, tmp_path / "shard"))
    # Two processes of all-core OpenMP pools spin against each other (38 s
    # against 1.4 s a run here): two threads each.
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), task], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    seen = sorted(json.loads(out.strip().splitlines()[-1])["rank"] for out, _ in outs)
    assert seen == [0, 1] and all(json.loads(o.strip().splitlines()[-1])["world"] == 2 for o, _ in outs)
    TorchRunner._configure_and_run(_task(data, unet, tmp_path / "all"))
    single = sorted(f for f in os.listdir(tmp_path / "all") if f.endswith(".zip"))
    shards = {f: r for r in (0, 1) for f in os.listdir(tmp_path / f"shard{r}") if f.endswith(".zip")}
    assert len(single) == 2 and sorted(shards) == single and set(shards.values()) == {0, 1}
    for f in single:
        chip_smoke.compare_archives(str(tmp_path / "all" / f), str(tmp_path / f"shard{shards[f]}" / f))
    assert tp.host_id() == 0 and tp.host_count() == 1  # this process joined no group


def test_make_mesh_and_setup_parallel_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.setup_parallel(tp.ParallelConfig())
    assert tp.setup_parallel(False) is None
    mesh = tp.setup_parallel(tp.ParallelConfig(), device="cpu")
    assert mesh.devices.shape == (1,) and mesh.axis_names == ("data",)
    mesh = tp.setup_parallel(tp.ParallelConfig(mesh={"data": 4, "model": 2}), device="cpu")
    assert mesh.devices.shape == (4, 2) and mesh.shape == {"data": 4, "model": 2}
    assert all(d == CPU for d in mesh.devices.flat)
    assert tp.shard_batch_spec(mesh, 4) == ("data", None, None, None)
    replicas = tp.replicate(torch.nn.Linear(2, 2), list(mesh.devices.flat))
    assert list(replicas) == [CPU]
