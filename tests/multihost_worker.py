"""One process of a two-process run, for ``tests/test_torch_multihost.py``.

    python tests/multihost_worker.py port|jax <rank> <address> <work dir>

``port`` joins a ``gloo`` group through the port's ``initialize_distributed``
and runs the cases of ``<work>/port_in.pt`` on a mesh that spans both
processes (4 CPU replicas each): each mesh's process and device layout, the
train steps, ``fit`` with and without a resume, and the loki and predict
Runners with a coordinator. ``jax`` runs two JAX processes of 4 virtual CPU
devices each (``jax.distributed``, ``gloo`` collectives): the meshes'
layouts, the mesh train step and the same Runners. Each process writes its
results to ``<work>/<kind>_out<rank>.pt`` and prints one JSON line.
"""

import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = [{"model": 2, "space": 2, "data": 2}, {"data": 2, "space": 2, "model": 2}, {"space": 4, "model": 2}]


def _runner_error(run) -> dict:
    try:
        run()
        return {"ok": True}
    except Exception as e:  # the outcome is the result here
        traceback.print_exc()
        return {"ok": False, "type": type(e).__name__, "message": str(e)}


def port(rank: int, address: str, work: str) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from maze_image_processing_pipeline_tpu_torch import parallel as tp
    from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as LokiRunner
    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit
    from maze_image_processing_pipeline_tpu_torch.models.unet import ShardedNet, UNet
    from maze_image_processing_pipeline_tpu_torch.parallel.mesh import mesh_grid
    from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner as PredictRunner

    inp = torch.load(os.path.join(work, "port_in.pt"), weights_only=False)
    tp.initialize_distributed(address, 2, rank, device="cpu")
    out = {"layouts": [], "cases": {}}
    for axes in LAYOUTS:
        mesh = tp.make_mesh(axes, devices=[torch.device("cpu", i) for i in range(4)])
        out["layouts"].append({"processes": mesh.processes.tolist(),
                               "index": np.vectorize(lambda d: d.index)(mesh.devices).tolist(),
                               "grid": mesh_grid(mesh, of=mesh.processes).tolist()})
    make = {"unet": UNet, "classifier": ConvClassifier}
    for name, case in inp["cases"].items():
        n = int(np.prod(list(case["axes"].values())))
        mesh = tp.make_mesh(case["axes"], devices=[torch.device("cpu")] * (n // 2))
        module = make[case["kind"]](**case["cfg"], dtype="float32")
        loss_fn = tt.bce_dice_loss if case["kind"] == "unet" else tt.bce_loss
        state, opt = tt.create_train_state(module, case["x"].shape, device="cpu", mesh=mesh)
        sharded = isinstance(state.module, ShardedNet)
        state.module.load_state_dict(case["init"])
        step = tt.make_train_step(module, opt, loss_fn=loss_fn, mesh=mesh)
        losses, params = [], []
        for _ in range(case["steps"]):
            state, m = step(state, case["x"], case["y"])
            losses.append(float(m["loss"]))
            params.append(state.module.state_dict() if sharded else
                          {k: v.detach().clone() for k, v in module.state_dict().items()})
        out["cases"][name] = {"losses": losses, "params": params, "sharded": sharded}
    # fit: three steps at once, and two steps then a resumed third.
    spec = inp["fit"]
    runs = {"whole": (3, "whole", spec["batches"]), "first": (2, "resumed", spec["batches"]),
            "rest": (3, "resumed", spec["batches"][2:])}
    for key, (n_steps, ckpt, batches) in runs.items():
        mesh = tp.make_mesh(spec["axes"], devices=[torch.device("cpu")] * 2)
        module = UNet(**spec["cfg"], dtype="float32")
        state = fit(module, iter(batches), n_steps, input_shape=batches[0][0].shape, mesh=mesh, device="cpu",
                    checkpoint_dir=os.path.join(work, f"ckpt_{ckpt}"), checkpoint_every=1, log_interval=1e9)
        out[f"fit_{key}"] = {"step": state.step, "params": {k: v.detach().clone() for k, v in module.state_dict().items()}}
    for name, task in inp["runners"].items():
        task = json.loads(json.dumps(task).replace("@RANK@", str(rank)))
        task["parallel"].update(coordinator_address=address, num_processes=2, process_id=rank)
        runner = LokiRunner if name.startswith("loki") else PredictRunner
        out[f"runner_{name}"] = _runner_error(lambda: runner._configure_and_run(task))
        tp.multihost.barrier()
    return out


def jax_run(rank: int, address: str, work: str) -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.experimental import multihost_utils

    from maze_image_processing_pipeline_tpu.loki.pipeline import Runner as LokiRunner
    from maze_image_processing_pipeline_tpu.models import train as j_train
    from maze_image_processing_pipeline_tpu.models.unet import UNet
    from maze_image_processing_pipeline_tpu.parallel import make_mesh
    from maze_image_processing_pipeline_tpu.predict.pipeline import Runner as PredictRunner

    inp = torch.load(os.path.join(work, "jax_in.pt"), weights_only=False)
    out = {}
    # The first Runner joins the processes (``jax.distributed.initialize``).
    for name, task in inp["runners"].items():
        task = json.loads(json.dumps(task).replace("@RANK@", str(rank)))
        task["parallel"].update(coordinator_address=address if name == "loki" else None, num_processes=2,
                                process_id=rank)
        runner = LokiRunner if name.startswith("loki") else PredictRunner
        out[f"runner_{name}"] = _runner_error(lambda: runner._configure_and_run(task))
        multihost_utils.sync_global_devices(name)
    order = {d: i for i, d in enumerate(jax.devices())}
    out.update(devices=[(d.id, d.process_index) for d in jax.devices()], layouts=[])
    for axes in LAYOUTS:
        mesh = make_mesh(axes)
        local = np.vectorize(lambda d: order[d] - sum(e.process_index < d.process_index for e in jax.devices()))
        out["layouts"].append({"processes": np.vectorize(lambda d: d.process_index)(mesh.devices).tolist(),
                               "index": local(mesh.devices).tolist()})
    step_case = inp["step"]
    mesh = make_mesh(step_case["axes"])
    module = UNet(**step_case["cfg"], dtype=jnp.float32)
    state, opt = j_train.create_train_state(module, jax.random.key(0), (2,) + step_case["x"].shape[1:], mesh=mesh)
    state, m = j_train.make_train_step(module, opt, mesh=mesh)(state, step_case["x"], step_case["y"])
    out["step_loss"] = float(m["loss"])
    return out


def main() -> None:
    kind, rank, address, work = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    out = port(rank, address, work) if kind == "port" else jax_run(rank, address, work)
    import torch

    torch.save(out, os.path.join(work, f"{kind}_out{rank}.pt"))
    print(json.dumps({"rank": rank, "kind": kind, "runners": {k: v for k, v in out.items() if k.startswith("runner_")}}))
    sys.stdout.flush()
    os._exit(0)  # jax.distributed's shutdown waits for the other process


if __name__ == "__main__":
    main()
