"""One rank of the port's data-parallel tests (started by ``tests/test_torch_parallel.py``).

    python torch_parallel_worker.py steps <rank> <world> <port> <workdir>
    python torch_parallel_worker.py trainer <rank> <world> <port> <workdir>

The rank joins a gloo group on the CPU through ``parallel.mesh.make_mesh`` (the
launcher's environment is set here) and writes what it saw to
``<workdir>/<mode>_rank<rank>.pt``:

- ``steps``: the mesh utilities (``shard_batch``, ``replicate``, ``host_max``,
  ``all_reduce_sum``, ``broadcast_values``), then for each case of
  ``<workdir>/steps_input.pt`` (a global batch, JAX's weights and JAX's draws for
  ``burnin_step`` x2 and ``mutual_step`` x1) the rank's share of the batch through
  the port's steps with the global draws: the metrics of each step summed over the
  ranks, and the final student and teacher;
- ``trainer``: ``PTrainer.train()`` on the micro config of ``<workdir>/trainer.yaml``
  with the first labeled and unlabeled batches its loader gave, its final student,
  whether it evaluated, and its results.

The TensorBoard writer is kept out (where TensorFlow is installed, its import
pulls it in and takes ~17 s); the JSON and console writers stay.
"""

import os
import sys

mode, rank, world, port, work = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
sys.modules["torch.utils.tensorboard"] = None   # ImportError: the writer is skipped

import torch  # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probabilisticteacher_torch.parallel import mesh as M  # noqa: E402


def run_steps():
    from probabilisticteacher_torch.config import Arch, get_cfg
    from probabilisticteacher_torch.engine.steps import create_train_state, make_train_steps
    from probabilisticteacher_torch.modeling.detector import PTDetector
    from probabilisticteacher_torch.solver import build_optimizer
    from probabilisticteacher_torch.structures import GroundTruth, ImageBatch

    mesh = M.make_mesh("cpu")
    assert mesh.world_size == world and mesh.rank == rank and mesh.backend == "gloo"
    out = {"utils": {
        "shard": M.shard_batch(mesh, {"x": torch.arange(8.0).reshape(4, 2),
                                      "t": (torch.arange(4),)}),
        "host_max": M.host_max(mesh, rank + 0.5),
        "sum": M.all_reduce_sum(mesh, torch.tensor([1.0, float(rank)])),
        "broadcast": M.broadcast_values(mesh, [rank + 7.0, 3.0]),
    }}
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank)
    out["utils"]["replicated"] = M.replicate(mesh, module).weight.detach().clone()

    inp = torch.load(os.path.join(work, "steps_input.pt"), weights_only=False)
    cfg = get_cfg()
    cfg.merge_from_list(inp["cfg"])
    for name, case in inp["cases"].items():
        det = PTDetector(Arch(**inp["arch"]), device="cpu")
        det.load_state_dict(case["params"])
        state = create_train_state(det, build_optimizer(cfg, det))
        burnin, mutual = make_train_steps(cfg, det, mesh)
        limg, lhw, uimg, uhw, boxes, cls, gt_valid = M.shard_batch(mesh, case["batch"])
        tl, tu = ImageBatch(limg, lhw), ImageBatch(uimg, uhw)
        tgt = GroundTruth(boxes, cls, gt_valid)
        metrics = []
        for step, draws in enumerate(case["draws"]):
            if step < 2:
                state, m = burnin(state, tl, tgt, draws)
            else:
                state, m = mutual(state, tl, tgt, tu, draws)
            names = sorted(m)
            total = M.all_reduce_sum(mesh, torch.stack([m[k].float() for k in names]))
            metrics.append(dict(zip(names, total.tolist())))
        out[name] = {"metrics": metrics, "student": state.student.state_dict(),
                     "teacher": state.teacher.state_dict()}
    return out


def run_trainer():
    from probabilisticteacher_torch.config import add_config, get_cfg
    from probabilisticteacher_torch.data.datasets import register_pascal_voc
    from probabilisticteacher_torch.engine.trainer import PTrainer

    classes = ("truck", "car", "rider", "person", "train", "motorcycle", "bicycle", "bus")
    for name, sub, split in (("dp_l", "src", "train"), ("dp_u", "tgt", "train"),
                             ("dp_v", "val", "val")):
        register_pascal_voc(name, os.path.join(work, "voc", sub), split, classes)
    cfg = get_cfg()
    add_config(cfg)
    cfg.merge_from_file(os.path.join(work, "trainer.yaml"))
    cfg.freeze()
    batches = []

    class Recording(PTrainer):
        def build_train_loader(self):
            loader = super().build_train_loader()

            def record():
                for batch in loader:
                    if len(batches) < 4:
                        batches.append(batch)
                    yield batch
            return record()

    trainer = Recording(cfg)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    return {"step": int(trainer.state.step), "mesh": (trainer.mesh.rank, trainer.mesh.world_size),
            "student": trainer.state.student.state_dict(),
            "teacher": trainer.state.teacher.state_dict(), "results": results,
            "evaluated": "mAP50" in trainer.storage.latest(), "batches": batches,
            "writers": len(trainer.writers)}


out = run_steps() if mode == "steps" else run_trainer()
torch.save(out, os.path.join(work, f"{mode}_rank{rank}.pt"))
print("done", rank)
