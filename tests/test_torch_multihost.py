"""A mesh that spans processes in the PyTorch port, against one process and the
JAX package.

Two processes join a ``gloo`` group (``tests/multihost_worker.py``, launched
as ``test_torch_parallel.py`` launches its two, each bounded in time and all
killed when one fails), each with 4 CPU replicas, and build meshes of 8
cards over both; two JAX processes of 4 virtual CPU devices each do the same
with ``jax.distributed``. Then:

* (a) ``make_mesh`` orders the cards process-major, as two JAX processes'
  ``jax.devices()``: the same process and local index at every mesh
  position, for layouts where ``model``, ``data`` and ``space`` cross;
* (b) the sharded ``UNet(1, 64, 1)`` step, two steps, where each of
  ``data``, ``space`` and ``model`` crosses the processes, gives the port's
  one-process step on a mesh of the same shape (losses and parameters
  within rtol 1e-6) and the JAX one-process mesh step
  (``test_torch_sharding.py``'s tolerances); the JAX step in two processes
  gives its one-process loss; a ``{space: 4}`` step whose second process
  holds only empty shares gives the one-process step;
* (c) the sharded ``ConvClassifier`` where ``space`` crosses and where
  ``model`` crosses: the port's one-process steps (two) and the JAX mesh
  step (the first, as ``test_torch_sharding.py`` holds it);
* (d) the data-parallel step on ``{data: 8}`` over both processes;
* (e) ``fit`` with ``checkpoint_every``: two steps and a resumed third
  equal three steps at once, and the checkpoint equals the one a single
  process writes on the same mesh;
* (f) the loki and predict Runners with a coordinator do what the JAX
  Runners do: loki (the host blend; the port's device path too) and
  polytaxo raise (the JAX package at its first fetch of an output on
  another process's device, the port at construction, naming
  ``input.num_shards``), semseg writes on every process the archive of one
  process; each node that refuses such a mesh, on a mesh that says
  another process holds a card.

The ``cuda`` tests move card tensors between two processes (``gloo`` staged
through the host on one card; ``nccl`` through each process's card where
the machine has two); they skip here.
"""

import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_sharding as sh
from maze_image_processing_pipeline_tpu_torch import parallel as tp
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models import train as t_train
from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet as TorchUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")
CPU = torch.device("cpu")
UNET = dict(out_channels=1, base_features=64, depth=1)
CLASSIFIER = dict(n_outputs=64, features=(16, 64))
# Each layout with the axis that crosses the two processes.
UNET_LAYOUTS = {"data": {"data": 2, "space": 2, "model": 2}, "space": {"space": 4, "model": 2},
                "model": {"model": 2, "space": 2, "data": 2}}
CLASSIFIER_LAYOUTS = {"space": {"space": 4, "model": 2}, "model": {"model": 2, "space": 4}}
DP_AXES = {"data": 8}
FIT_AXES = {"space": 2, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _needs_a_card(cards: int = 1) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s)")


def _launch(kind: str, work: str) -> list:
    """Two processes of ``multihost_worker.py`` (``kind``), two threads each."""
    address = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return [subprocess.Popen([sys.executable, WORKER, kind, str(r), address, work], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]


def _finish(procs, timeout: float = 240) -> None:
    """Wait for both; kill both when one fails or hangs."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]


def _unet_batch():
    return sh._batch(np.random.default_rng(0), 4, 32, 32)


def _classifier_batch():
    rng = np.random.default_rng(7)
    return rng.random((4, 32, 32, 3)).astype(np.float32), (rng.random((4, 64)) > 0.5).astype(np.float32)


def _fit_batches():
    rng = np.random.default_rng(3)
    return [sh._batch(rng, 2, 32, 32) for _ in range(3)]


def _jax_init(kind: str):
    """The JAX initial parameters of the U-Net or the classifier, as a port
    state dict."""
    import jax
    import jax.numpy as jnp

    from maze_image_processing_pipeline_tpu.models.classifier import ConvClassifier as JaxClassifier
    from maze_image_processing_pipeline_tpu.models.unet import UNet as JaxUNet

    module = JaxUNet(**UNET, dtype=jnp.float32) if kind == "unet" else JaxClassifier(**CLASSIFIER, dtype=jnp.float32)
    params = module.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.float32))
    return t_model_io.params_from_jax(jax.tree.map(np.asarray, params))


def _tasks(root) -> dict:
    """The Runners' tasks (``@RANK@`` names each process's output); every
    process takes every sample, on a mesh of all 8 cards."""
    seg = {"model_fn": str(root / "unet"), "device": "cpu", "dtype": "float32", "batch_size": 4, "tile_size": 128,
           "tile_stride": 96, "stitch": True, "frame_batch": 1,
           "postprocess": {"closing_radius": 2, "min_area": 20, "max_regions": 16}, "padding": 10}
    par = {"mesh": {"data": 8}}

    def loki(name, **kw):
        return {"input": {"path": str(root / "data")}, "segmentation": {"jax": {**seg, **kw}}, "postprocess": {},
                "output": {"target_dir": str(root / f"{name}_@RANK@"), "store_mask": True}, "parallel": dict(par)}

    semseg = chip_smoke.semseg_task(str(root / "crops.zip"), str(root / "semunet"), str(root / "semseg_@RANK@"),
                                    device="cpu", dtype="float32", batch_size=2, tiling={"size": 64, "stride": 48})
    polytaxo = chip_smoke.polytaxo_task(str(root / "crops.zip"), str(root / "clf"), str(root / "polytaxo_@RANK@"),
                                        (str(root / "tax" / "taxonomy.yaml"),
                                         str(root / "tax" / "ecotaxa_taxonomy.csv")),
                                        device="cpu", dtype="float32", batch_size=4, input_size=64)
    return {"loki": loki("loki", device_blend=False), "loki_device": loki("loki_device"),
            "semseg": {**semseg, "parallel": dict(par)}, "polytaxo": {**polytaxo, "parallel": dict(par)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pairs of processes, started together; their results by kind
    and rank, with the inputs they took."""
    from fixtures import make_loki_sample

    root = tmp_path_factory.mktemp("multihost")
    make_loki_sample(str(root / "data"), n_frames=2, objects_per_frame=3, frame_shape=(180, 230))
    chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    chip_smoke.make_crop_archive(str(root / "crops.zip"), [(64, 64), (100, 90), (40, 56)], seed=0)
    chip_smoke.write_unet(str(root / "semunet"), chip_smoke.SMALL_SEMSEG_UNET, "float32", seed=0, gain=1000.0,
                          channel_names=chip_smoke.CHANNELS)
    chip_smoke.write_classifier(str(root / "clf"), chip_smoke.SMALL_CLASSIFIER, "float32", seed=0)
    chip_smoke.make_taxonomy_files(str(root / "tax"))
    tasks = _tasks(root)
    x, y = _unet_batch()
    xc, yc = _classifier_batch()
    init = {"unet": _jax_init("unet"), "classifier": _jax_init("classifier")}
    cases = {f"unet_{a}": dict(kind="unet", cfg=UNET, axes=axes, x=x, y=y, init=init["unet"], steps=2)
             for a, axes in UNET_LAYOUTS.items()}
    cases.update({f"classifier_{a}": dict(kind="classifier", cfg=CLASSIFIER, axes=axes, x=xc, y=yc,
                                          init=init["classifier"], steps=2) for a, axes in CLASSIFIER_LAYOUTS.items()})
    # Rows 4 + 4 + 0 + 0: the second process holds only the empty shares.
    xe, ye = sh._batch(np.random.default_rng(8), 2, 8, 16, out=2)
    small = dict(out_channels=2, base_features=8, depth=2)
    small_init = t_model_io.params_from_jax(t_model_io.init_unet_params(dict(small, in_channels=3), seed=4))
    cases["unet_empty"] = dict(kind="unet", cfg=small, axes={"space": 4, "data": 2}, x=xe, y=ye, init=small_init,
                               steps=2)
    xd, yd = sh._batch(np.random.default_rng(9), 8, 32, 32, out=2)
    cases["data_parallel"] = dict(kind="unet", cfg=small, axes=DP_AXES, x=xd, y=yd, init=small_init, steps=2)
    port_in = {"cases": cases, "fit": {"axes": FIT_AXES, "cfg": UNET, "batches": _fit_batches()}, "runners": tasks}
    torch.save(port_in, root / "port_in.pt")
    # The JAX package's loki device path raises only in a process that meets
    # another process's device in its frame groups' round-robin; its host
    # blend raises in every process, at a tenth of the compile time.
    jax_tasks = {k: v for k, v in tasks.items() if k != "loki_device"}
    torch.save({"step": {"axes": UNET_LAYOUTS["model"], "cfg": UNET, "x": x, "y": y}, "runners": jax_tasks},
               root / "jax_in.pt")
    procs = {kind: _launch(kind, str(root)) for kind in ("port", "jax")}
    try:  # the one-process references, while the processes run
        refs = _references(port_in, tasks, root)
    finally:
        for kind in ("port", "jax"):
            _finish(procs[kind])
    out = {kind: [torch.load(root / f"{kind}_out{r}.pt", weights_only=False) for r in (0, 1)]
           for kind in ("port", "jax")}
    return {"root": root, "out": out, "port_in": port_in, "refs": refs}


def _references(port_in, tasks, root) -> dict:
    """Each case's port step in this process on a mesh of the same shape
    (CPU replicas) and, for the U-Net and classifier cases, the JAX mesh
    step (its virtual devices); the one-process ``fit`` of the fit case;
    the one-process semseg archives of both packages."""
    from maze_image_processing_pipeline_tpu.predict.pipeline import Runner as JaxPredict
    from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner as TorchPredict

    refs = {"one": {}, "jax": {}}
    for name, case in port_in["cases"].items():
        make = TorchUNet if case["kind"] == "unet" else ConvClassifier
        loss_fn = t_train.bce_dice_loss if case["kind"] == "unet" else t_train.bce_loss
        refs["one"][name] = sh._port_steps(case["cfg"], case["init"], sh._cpu_mesh(case["axes"]), case["x"],
                                           case["y"], case["steps"], make=make, loss_fn=loss_fn, every_step=True)
        if name.startswith(("unet_", "classifier_")) and name != "unet_empty":
            steps = 2 if case["kind"] == "unet" else 1
            refs["jax"][name] = _jax_mesh_steps(case["kind"], case["axes"], case["x"], case["y"], steps)
    spec = port_in["fit"]
    module = TorchUNet(**spec["cfg"], dtype="float32")
    fit(module, iter(spec["batches"]), 3, input_shape=spec["batches"][0][0].shape, mesh=sh._cpu_mesh(FIT_AXES),
        device="cpu", checkpoint_dir=str(root / "ckpt_one"), checkpoint_every=1, log_interval=1e9)
    refs["fit"] = dict(module.state_dict())
    for runner, ref in ((JaxPredict, "jax"), (TorchPredict, "port")):
        runner._configure_and_run(dict(tasks["semseg"], target_dir=str(root / f"semseg_one_{ref}"), parallel=False))
    return refs


def test_make_mesh_orders_cards_as_two_jax_processes(runs):
    """(a) The process and the local index of the card at every position of
    each mesh, in both processes, equal the JAX meshes'; ``mesh_grid`` then
    sends ``model``, ``data`` or ``space`` across the processes as the
    layout says."""
    jax_out = runs["out"]["jax"]
    assert jax_out[0]["devices"] == [(i, 0) for i in range(4)] + [(2048 + i, 1) for i in range(4)]
    for r in (0, 1):
        for port, ref in zip(runs["out"]["port"][r]["layouts"], jax_out[r]["layouts"]):
            assert port["processes"] == ref["processes"] and port["index"] == ref["index"]
    grids = [np.asarray(layout["grid"]) for layout in runs["out"]["port"][0]["layouts"]]
    # (data, space, model) grids: model crosses, then data, then space.
    assert (grids[0][:, :, 0] == 0).all() and (grids[0][:, :, 1] == 1).all()
    assert (grids[1][0] == 0).all() and (grids[1][1] == 1).all()
    assert (grids[2][0, :2] == 0).all() and (grids[2][0, 2:] == 1).all()


def _jax_mesh_steps(kind, axes, x, y, steps):
    """The JAX one-process mesh step (virtual devices of this process):
    the losses and the parameters after each step, as port state dicts."""
    import jax
    import jax.numpy as jnp

    from maze_image_processing_pipeline_tpu.models import train as j_train
    from maze_image_processing_pipeline_tpu.models.classifier import ConvClassifier as JaxClassifier
    from maze_image_processing_pipeline_tpu.models.unet import UNet as JaxUNet
    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh

    mesh = j_make_mesh(axes, devices=jax.devices()[: math.prod(axes.values())])
    if kind == "unet":
        module, loss_fn = JaxUNet(**UNET, dtype=jnp.float32), j_train.bce_dice_loss
    else:
        module, loss_fn = JaxClassifier(**CLASSIFIER, dtype=jnp.float32), j_train.bce_loss
    state, opt = j_train.create_train_state(module, jax.random.key(0), (2, 32, 32, 3), mesh=mesh)
    step = j_train.make_train_step(module, opt, loss_fn=loss_fn, mesh=mesh)
    losses, params = [], []
    for _ in range(steps):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        params.append(t_model_io.params_from_jax(jax.tree.map(np.asarray, state.params)))
    return losses, params


def _hold_equal(params, ref) -> None:
    for k, v in ref.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-6, atol=0, err_msg=k)


def _port_case(runs, name):
    """The case's two-process results (both processes' parameters equal)
    and the port's one-process run of the same mesh."""
    outs = [runs["out"]["port"][r]["cases"][name] for r in (0, 1)]
    assert outs[0]["losses"] == outs[1]["losses"]
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        _hold_equal(a, b)
    one = runs["refs"]["one"][name]
    np.testing.assert_allclose(outs[0]["losses"], one[0], rtol=1e-6)
    for got, ref in zip(outs[0]["params"], one[2]):
        _hold_equal(got, ref)
    return outs[0], one


@pytest.mark.parametrize("crosses", list(UNET_LAYOUTS))
def test_sharded_unet_step_across_processes(runs, crosses):
    """(b) ``UNet(1, 64, 1)`` float32, two steps from the JAX initial
    parameters, with ``crosses`` across the processes: the port's
    one-process step (rtol 1e-6) and the JAX mesh step on the same mesh
    (``test_torch_sharding.py``'s tolerances). Where ``model`` crosses, the
    JAX step in two processes gives the first loss of the JAX step in one."""
    got, (_, grads, _) = _port_case(runs, f"unet_{crosses}")
    assert got["sharded"]
    j_losses, j_params = runs["refs"]["jax"][f"unet_{crosses}"]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads[0].values()))
    sh._hold_params(got["params"][1], j_params[1], grads, total, 2)
    if crosses == "model":
        for r in (0, 1):
            np.testing.assert_allclose(runs["out"]["jax"][r]["step_loss"], j_losses[0], rtol=1e-6)


@pytest.mark.parametrize("crosses", list(CLASSIFIER_LAYOUTS))
def test_sharded_classifier_step_across_processes(runs, crosses):
    """(c) ``ConvClassifier(64, (16, 64))`` float32, ``bce_loss``: two steps
    against the port's one-process step (rtol 1e-6), the first against the
    JAX mesh step (``test_torch_sharding.py`` holds that step to its
    first)."""
    got, (_, grads, _) = _port_case(runs, f"classifier_{crosses}")
    assert got["sharded"]
    j_losses, j_params = runs["refs"]["jax"][f"classifier_{crosses}"]
    np.testing.assert_allclose(got["losses"][0], j_losses[0], rtol=1e-5)
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads[0].values()))
    sh._hold_params(got["params"][0], j_params[0], grads[:1], total, 1, sh._classifier_norm_bias)


@pytest.mark.parametrize("name", ["unet_empty", "data_parallel"])
def test_empty_shares_and_the_data_parallel_step_across_processes(runs, name):
    """A ``{space: 4, data: 2}`` step whose second process holds only
    shares without rows (it computes nothing and receives the loss and
    the parameters), and (d) the data-parallel step of a U-Net that no
    axis shards on ``{data: 8}``: the port's one-process step, two steps
    (rtol 1e-6)."""
    got, _ = _port_case(runs, name)
    assert got["sharded"] == (name == "unet_empty")


def test_fit_resumes_across_processes(runs):
    """(e) ``fit`` on ``{space: 2, model: 2}`` over both processes with a
    checkpoint every step: two steps, then a resumed run to three, gives
    the weights of three steps at once on both processes; the third
    step's checkpoint (the whole parameters, the owners' AdamW moments)
    equals the one-process ``fit``'s on the same mesh."""
    port = runs["out"]["port"]
    for r in (0, 1):
        assert port[r]["fit_whole"]["step"] == port[r]["fit_rest"]["step"] == 3
        _hold_equal(port[r]["fit_rest"]["params"], port[r]["fit_whole"]["params"])
        _hold_equal(port[r]["fit_whole"]["params"], port[0]["fit_whole"]["params"])
    _hold_equal(port[0]["fit_whole"]["params"], runs["refs"]["fit"])
    one = torch.load(runs["root"] / "ckpt_one" / "3" / "state.pt", weights_only=True)
    for ckpt in ("whole", "resumed"):
        two = torch.load(runs["root"] / f"ckpt_{ckpt}" / "3" / "state.pt", weights_only=True)
        assert two["step"] == 3
        _hold_equal(two["model"], one["model"])
        assert two["optimizer"]["param_groups"] == one["optimizer"]["param_groups"]
        assert sorted(two["optimizer"]["state"]) == sorted(one["optimizer"]["state"])
        for i, st in one["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(two["optimizer"]["state"][i][k], st[k]), (i, k)


def test_runners_on_a_mesh_across_processes_do_what_the_jax_runners_do(runs):
    """(f) With a coordinator and a mesh of both processes' cards: the JAX
    loki Runner (the host blend) and predict's polytaxo raise in every
    process at their first fetch of an output on another process's
    device, and the port's raise in both processes when they build the
    node, naming the per-host sample shards (loki's device path too);
    predict's semseg (the device blend) writes on every process, in both
    packages, the archive of one process."""
    jax_out, port = runs["out"]["jax"], runs["out"]["port"]
    fetch = "spans non-addressable"
    for name in ("loki", "polytaxo"):
        assert all(not o[f"runner_{name}"]["ok"] and fetch in o[f"runner_{name}"]["message"] for o in jax_out)
    for name, node in (("loki", "TorchInference"), ("loki_device", "DeviceTiledSegmentation"),
                       ("polytaxo", "TorchInference")):
        for o in port:
            err = o[f"runner_{name}"]
            assert not err["ok"] and err["type"] == "ValueError", err
            assert err["message"].startswith(f"{node}: the mesh") and "input.num_shards" in err["message"]
    root, fn = runs["root"], "crops.segmentation.zip"
    for r in (0, 1):
        assert jax_out[r]["runner_semseg"]["ok"] and port[r]["runner_semseg"]["ok"]
        for ref in ("jax", "port"):
            assert chip_smoke.compare_archives(str(root / f"semseg_one_{ref}" / fn), str(root / f"semseg_{r}" / fn)) == 3


def test_inference_nodes_refuse_a_mesh_that_holds_another_process_cards():
    """The loki device nodes and ``TorchInference`` raise when they are
    built on a mesh whose second card another process holds (no process
    group needed: the mesh says where each card lies); ``require_local``
    passes this process's own mesh."""
    from maze_image_processing_pipeline_tpu_torch.loki.device_seg import (
        DeviceFramePostprocess, DeviceTiledSegmentation)
    from maze_image_processing_pipeline_tpu_torch.models.inference import TorchInference
    from maze_image_processing_pipeline_tpu_torch.parallel.mesh import Mesh, require_local

    cards = np.empty(2, dtype=object)
    cards[:] = [CPU, CPU]
    spanning = Mesh(cards, ("data",), processes=[0, 1])
    assert spanning.spans_processes and spanning.local_devices() == [CPU]
    require_local(Mesh(cards, ("data",)), "node")
    nodes = {"DeviceTiledSegmentation": lambda: DeviceTiledSegmentation(None, None, None, None, mesh=spanning),
             "DeviceFramePostprocess": lambda: DeviceFramePostprocess(None, None, None, mesh=spanning),
             "TorchInference": lambda: TorchInference(None, None, mesh=spanning)}
    for name, build in nodes.items():
        with pytest.raises(ValueError, match=f"^{name}: the mesh .* input.num_shards and input.shard_index"):
            build()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_cuda_exchange_moves_card_tensors_between_processes(backend):
    """``parallel.multihost.exchange`` between two processes of card
    tensors of three dtypes and layouts: ``gloo`` stages them through the
    host (both processes on card 0), ``nccl`` through each process's own
    card (two cards needed). The received tensors equal the sent ones, in
    the sender's layout."""
    _needs_a_card(2 if backend == "nccl" else 1)
    script = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from maze_image_processing_pipeline_tpu_torch.parallel import multihost as mh\n"
        "r, address, backend = int(sys.argv[1]), sys.argv[2], sys.argv[3]\n"
        "dev = torch.device('cuda', r if backend == 'nccl' else 0)\n"
        "torch.cuda.set_device(dev)\n"
        "mh.initialize_distributed(address, 2, r, device='cuda' if backend == 'nccl' else 'cpu')\n"
        "g = torch.Generator(device=dev).manual_seed(r)\n"
        "mine = [torch.randn(3, 5, 7, 9, device=dev, generator=g).contiguous(memory_format=torch.channels_last),\n"
        "        torch.randn(4, 33, device=dev, generator=g).to(torch.bfloat16), torch.arange(5, device=dev)]\n"
        "got = mh.exchange({1 - r: mine}, {1 - r: [(tuple(t.shape), t.dtype, dev) for t in mine]},\n"
        "                  mh.staging_device([dev]))[1 - r]\n"
        "g = torch.Generator(device=dev).manual_seed(1 - r)\n"
        "want = [torch.randn(3, 5, 7, 9, device=dev, generator=g), torch.randn(4, 33, device=dev, generator=g)\n"
        "        .to(torch.bfloat16), torch.arange(5, device=dev)]\n"
        "assert all(torch.equal(a, b) and a.device == dev for a, b in zip(got, want))\n"
        "assert got[0].is_contiguous(memory_format=torch.channels_last)\n"
        "print('ok')\n"
    )
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), address, backend], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    _finish(procs, timeout=300)


@pytest.mark.cuda
def test_cuda_make_mesh_takes_each_process_cards():
    """Without a process group ``make_mesh()`` is the machine's cards, all
    of this process."""
    _needs_a_card()
    mesh = tp.make_mesh()
    assert not mesh.spans_processes and not mesh.processes.any()
    assert mesh.local_devices() == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
