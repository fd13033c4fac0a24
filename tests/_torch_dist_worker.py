"""One rank of a gloo world for tests/test_torch_parallel_world.py.

    python tests/_torch_dist_worker.py <rank> <world> <data> <model> <dir>

`<dir>` holds `inputs.pt` (written by the test: the model's config and
init state_dict, the global batch, the training config's fields, the
predictions for the CCC) and a `store` file for the rendezvous
(file://), and gets `rank<r>.pt`, this rank's results, and the checkpoint
directories. The process imports torch and the port only: JAX and the JAX
package are blocked, so an import of either fails.
"""

import os
import sys

sys.modules["jax"] = None  # importing JAX here raises ImportError
sys.modules["tpu_deer"] = None

import torch  # noqa: E402

torch.set_num_threads(1)

from tpu_deer_torch.core.metrics import ccc_from_stats  # noqa: E402
from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator  # noqa: E402
from tpu_deer_torch.models.deer_model import (  # noqa: E402
    CompleteDEERModel,
    DEERModelConfig,
)
from tpu_deer_torch.parallel import (  # noqa: E402
    MeshConfig,
    RuntimeConfig,
    global_ccc_stats,
    initialize_runtime,
    shard_batch,
    shard_params,
    shutdown_runtime,
)
from tpu_deer_torch.parallel.mesh import coordinate  # noqa: E402
from tpu_deer_torch.train.checkpoint import CheckpointManager  # noqa: E402
from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig  # noqa: E402

MODES = ("tp", "fsdp", "replicated")


def trainer_for(inputs, mode, mesh, runtime, dropout=False, **overrides):
    model = CompleteDEERModel(DEERModelConfig(**inputs["model"]))
    model.load_state_dict(inputs["init"])
    for m in model.modules():  # dropout off, as the reference's wrapper
        if isinstance(m, torch.nn.Dropout) and not dropout:
            m.p = 0.0
    config = TrainingConfig(**{**inputs["training"], "param_sharding": mode,
                               **overrides})
    return DEERTrainer(model, config, steps_per_epoch=inputs["steps"],
                       mesh=mesh, runtime=runtime, device="cpu")


def full_params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def main(rank, world, data, model, root):
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    runtime = initialize_runtime(RuntimeConfig(
        coordinator_address="file://" + os.path.join(root, "store"),
        num_processes=world, process_id=rank), device="cpu")
    mesh = runtime.global_mesh(MeshConfig(data=data, model=model))
    batch = inputs["batch"]
    out = {"coordinate": coordinate(mesh), "jax_loaded": "jax" in {
        m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}}

    # CCC from psum'd sufficient statistics, and this shard's own.
    local = shard_batch({"y": batch["labels"], "p": inputs["pred"]}, mesh)
    stats = global_ccc_stats(local["y"], local["p"],
                             group=mesh.get_group("data"))
    out["ccc"] = ccc_from_stats(stats)
    out["stats"] = global_ccc_stats(local["y"], local["p"])

    # Per-process BatchIterator rows → this process's rows of the batch.
    it = BatchIterator(ArrayDataset(dict(batch)), len(batch["labels"]),
                       shuffle=False, process_index=runtime.process_index,
                       process_count=runtime.process_count)
    rows = next(iter(it.epoch(0)))
    assembled = runtime.shard_batch({k: rows[k] for k in batch}, mesh)
    direct = shard_batch(batch, mesh)
    out["assembled_equal"] = all(torch.equal(assembled[k], direct[k])
                                 for k in batch)
    out["local_rows"] = len(direct["labels"])

    # shard_params: every process's pieces make the whole tensor again.
    placed = shard_params(inputs["init"], mesh, mode="fsdp")
    out["shard_params"] = all(
        torch.equal(v.full_tensor(), inputs["init"][k]) for k, v in placed.items())
    out["shard_params_split"] = sorted(
        k for k, v in placed.items() if any(p.is_shard() for p in v.placements))

    # Two steps under each layout; with the model's dropout too, and under
    # remat (the recomputed forward draws the masks again).
    def two_steps(trainer):
        steps = [trainer._train_step(direct, 1.0, 1.0) for _ in range(2)]
        return {"loss": [float(a["loss"]) for a in steps],
                "grad_norm": [float(a["grad_norm"]) for a in steps],
                "params": full_params(trainer)}

    trainers = {}
    for mode in MODES:
        trainer = trainer_for(inputs, mode, mesh, runtime)
        out[mode] = {**two_steps(trainer), "split": list(trainer._layout.split)}
        trainers[mode] = trainer
        out[f"{mode}_dropout"] = two_steps(
            trainer_for(inputs, mode, mesh, runtime, dropout=True))
    out["fsdp_dropout_remat"] = two_steps(
        trainer_for(inputs, "fsdp", mesh, runtime, dropout=True, remat=True))
    try:
        trainer_for(inputs, "fsdp", mesh, runtime,
                    batch_size=inputs["training"]["batch_size"] + 1)
    except ValueError as e:
        out["indivisible"] = str(e)
    # The trainer takes global batches: an iterator sliced per process raises.
    try:
        trainer_for(inputs, "fsdp", mesh, runtime).train_epoch({"s": BatchIterator(
            ArrayDataset(dict(batch)), len(batch["labels"]),
            process_index=runtime.process_index,
            process_count=runtime.process_count)}, 0)
    except ValueError as e:
        out["per_process_iterator"] = str(e)

    # Checkpoints of the fsdp state: save (every rank), restore onto its
    # own placements, across layouts onto tp; best and pruning.
    fsdp = trainers["fsdp"]
    ckpt = CheckpointManager(os.path.join(root, "ckpt"), keep_last=2)
    import tpu_deer_torch.train.checkpoint as checkpoint_lib

    written = []
    snapshot = checkpoint_lib._snapshot_chunks

    def recording(flat):
        manifest, chunks = snapshot(flat)
        written.append([name for name, _ in chunks])
        return manifest, chunks

    checkpoint_lib._snapshot_chunks = recording
    for step in (1, 2, 3):
        ckpt.save(fsdp.state_dict(), step=step, is_best=step == 2,
                  metrics={"epoch": step})
    checkpoint_lib._snapshot_chunks = snapshot
    out["written"] = written
    state = fsdp.state_dict()
    restored = ckpt.restore(step=3, template=state)
    out["restored_equal"] = all(
        torch.equal(restored["optimizer"][g][n].to_local(),
                    state["optimizer"][g][n].to_local())
        for g in ("mu", "nu") for n in state["optimizer"][g]) and all(
        torch.equal(restored["model"][n].to_local(), v.to_local())
        for n, v in state["model"].items()) and restored["step"] == fsdp.step
    tp = trainer_for(inputs, "tp", mesh, runtime)
    tp.load_state_dict(ckpt.restore(step=3, template=tp.state_dict()))
    out["cross_layout"] = {"params": full_params(tp),
                           "mu": {n: t.clone() for n, t in
                                  tp.optimizer.state["mu"].items()},
                           "step": tp.step}
    out["fsdp_mu"] = {n: t.clone() for n, t in fsdp.optimizer.state["mu"].items()}
    resumed = tp._train_step(direct, 1.0, 1.0)
    again = fsdp._train_step(direct, 1.0, 1.0)
    out["resumed_loss"] = (float(resumed["loss"]), float(again["loss"]))
    # The whole loop under fsdp: an epoch with validation and checkpoints,
    # then a new trainer resuming from them for a second epoch.
    data = ({"s": ArrayDataset(dict(batch), "s")},
            {"s": ArrayDataset(dict(batch), "s")})
    loop = CheckpointManager(os.path.join(root, "loop"))
    first = trainer_for(inputs, "fsdp", mesh, runtime, num_epochs=2)
    out["loop_first"] = first.train(*data, num_epochs=1, checkpoints=loop)["best_val_ccc"]
    resumed = trainer_for(inputs, "fsdp", mesh, runtime, num_epochs=2)
    result = resumed.train(*data, checkpoints=loop, resume=True)
    out["loop"] = {"best_val_ccc": result["best_val_ccc"],
                   "final_step": result["final_step"],
                   "params": full_params(resumed)}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    shutdown_runtime(runtime)


if __name__ == "__main__":
    rank, world, data, model = map(int, sys.argv[1:5])
    main(rank, world, data, model, sys.argv[5])
