"""One rank of a gloo world for tests/test_torch_parallel_world.py.

    python tests/_torch_dist_worker.py <rank> <world> <data> <model> <dir>

`<dir>` holds `inputs.pt` (written by the test: the model's config and
init state_dict, the global batch, the training config's fields, the
predictions for the CCC, and under "par" the inputs of the ring, GPipe,
MoE, ensemble and dry-run checks) and a `store` file for the rendezvous
(file://), and gets `rank<r>.pt`, this rank's results, and the checkpoint
directories. The process imports torch and the port only: JAX and the JAX
package are blocked, so an import of either fails.
"""

import os
import sys
from unittest import mock

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
    out.update(sequence_pipeline_expert(inputs["par"], runtime, mesh, root))
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    shutdown_runtime(runtime)


def _grads(loss, tensors):
    return [t.detach().clone() for t in torch.autograd.grad(loss, tensors)]


def sequence_pipeline_expert(par, runtime, mesh, root):
    """Ring attention, GPipe and the expert-parallel MoE over every rank of
    the world; at world 4 also a 2 × 2 ("data", "seq") ring, the ring at
    T 256, two steps of the ensemble on the ("data", "model") mesh and its
    sharded checkpoint, and the dry run. Outputs are this rank's; the
    gradients of global inputs are this rank's part (the test sums them)."""
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_deer_torch.models.deer_model import structure
    from tpu_deer_torch.models.fusion import MoEFusion
    from tpu_deer_torch.parallel.dryrun import dryrun_batch, dryrun_multichip
    from tpu_deer_torch.parallel.mesh import expert_parallel, shard_moe_params
    from tpu_deer_torch.parallel.pipeline import pipeline_sharded
    from tpu_deer_torch.parallel.sequence import ring_attention_sharded
    from tpu_deer_torch.train.ensemble import EnsembleTrainer

    world = runtime.process_count
    res = {}
    leaf = lambda a: torch.from_numpy(a).requires_grad_(True)

    # Ring attention over ("seq",) of every rank: unmasked (B 2) and with
    # key lengths 37, 53 and 0 (an all-masked element).
    seq = init_device_mesh("cpu", (world,), mesh_dim_names=("seq",))
    ring = par["ring"]
    for case, rows, mask in (("plain", slice(0, 2), None),
                             ("masked", slice(None), ring["mask"])):
        q, k, v = (leaf(ring[x][rows]) for x in "qkv")
        got = ring_attention_sharded(
            seq, q, k, v, None if mask is None else torch.from_numpy(mask))
        block = got.shape[2]
        w = torch.from_numpy(ring["w"][rows]).narrow(
            2, seq.get_local_rank("seq") * block, block)
        res[f"ring_{case}"] = {"out": got.detach(),
                               "grads": _grads((got * w).sum(), (q, k, v))}
    if world == 4:
        dp = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "seq"))
        res["ring_dp"] = {"out": ring_attention_sharded(
            dp, *(torch.from_numpy(par["ring_dp"][x]) for x in "qkv")),
            "coords": (dp.get_local_rank("data"), dp.get_local_rank("seq"))}
        res["ring_t256"] = ring_attention_sharded(
            seq, *(torch.from_numpy(par["ring_t256"][x]) for x in "qkv"))

    # GPipe over ("stage",): S = world, M = 2·S; gradients of the stacked
    # parameters and of x; M ∈ {2, 6, 12} on 24 rows; a ragged split.
    stage = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    pipe = par["pipe"]
    fn = lambda p, h: h + torch.tanh(h @ p["w"] + p["b"])
    params = {"w": leaf(pipe["w"]), "b": leaf(pipe["b"])}
    x = leaf(pipe["x"])
    got = pipeline_sharded(stage, fn, params, x, num_microbatches=2 * world)
    loss = torch.mean((got - torch.from_numpy(pipe["y"])) ** 2)
    res["pipe"] = {"out": got.detach(),
                   "grads": _grads(loss, (params["w"], params["b"], x))}
    frozen = {k: v.detach() for k, v in params.items()}
    res["pipe_micro"] = [pipeline_sharded(
        stage, fn, frozen, torch.from_numpy(pipe["x24"]), num_microbatches=m)
        for m in (2, 6, 12)]
    try:
        pipeline_sharded(stage, fn, frozen, torch.zeros(10, pipe["x"].shape[1]),
                         num_microbatches=3)
    except ValueError as e:
        res["pipe_ragged"] = str(e)

    # MoEFusion: the replicated module, then its experts split over
    # ("expert",); forwards and the gradients of a mean-square loss.
    moe_in = par["moe"]
    mods = [torch.from_numpy(m) for m in moe_in["mods"]]
    expert = init_device_mesh("cpu", (world,), mesh_dim_names=("expert",))
    for case in ("replicated", "sharded"):
        moe = MoEFusion(*moe_in["args"], **moe_in["kwargs"])
        moe.load_state_dict(moe_in["init"])
        if case == "sharded":
            expert_parallel(moe, expert)
        xs = [m.clone().requires_grad_(True) for m in mods]
        got = moe(xs)
        names, tensors = zip(*moe.named_parameters())
        grads = _grads(torch.mean(got ** 2), (*tensors, *xs))
        res[f"moe_{case}"] = {"out": got.detach(),
                              "grads": dict(zip(names, grads)),
                              "mod_grads": grads[len(names):],
                              "experts": getattr(moe, "expert_range", None)}
    placed = shard_moe_params(moe_in["init"], expert)
    res["moe_placed"] = {
        name: {"placements": [getattr(p, "dim", None) if p.is_shard() else "R"
                              for p in d.placements],
               "rows": d.to_local().shape[0],
               "whole": torch.equal(d.full_tensor(), moe_in["init"][name])}
        for name, d in placed.items()}
    if world != 4:
        return res

    # The ensemble on the 2 × 2 ("data", "model") mesh under 'ensemble':
    # the dry run's configuration and batch, two steps each with dropout
    # off and on; then its state saved in the sharded format and restored.
    ens = par["ensemble"]
    local = shard_batch(dryrun_batch(world), mesh)
    for case, drop in (("ensemble", False), ("ensemble_dropout", True)):
        model = structure(DEERModelConfig(**ens["model"]))
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout) and not drop:
                m.p = 0.0
        trainer = EnsembleTrainer(
            model, ens["init"], TrainingConfig(**ens["training"]),
            steps_per_epoch=1, mesh=mesh, runtime=runtime, device="cpu")
        steps = [trainer._train_step(local, 1.0, 1.0) for _ in range(2)]
        res[case] = {"loss": [float(a["loss"]) for a in steps],
                     "grad_norm": [float(a["grad_norm"]) for a in steps],
                     "params": {k: v.detach().clone()
                                for k, v in trainer.params.items()},
                     "split": list(trainer._layout.split)}
    state = trainer.state_dict()
    ckpt = CheckpointManager(os.path.join(root, "ens_ckpt"))
    ckpt.save(state, step=trainer.step)
    ckpt.wait()
    back = ckpt.restore(step=trainer.step, template=state)
    res["ensemble_ckpt"] = {
        "dtensors": sum(hasattr(v, "placements") for v in state["model"].values()),
        "equal": all(torch.equal(back["model"][k].to_local(), v.to_local())
                     for k, v in state["model"].items())}
    # The dry run with every dropout of its models off, as the reference's
    # deterministic steps that the test compares it with: each nn.Dropout it
    # builds gets p = 0 (the model's config sets only some of their rates).
    dropout_init = torch.nn.Dropout.__init__
    with mock.patch.object(torch.nn.Dropout, "__init__",
                           lambda self, p=0.5, inplace=False:
                           dropout_init(self, 0.0, inplace)):
        res["dryrun"] = dryrun_multichip(world, par["dryrun_init"], ens["init"],
                                         device="cpu")
    return res


if __name__ == "__main__":
    rank, world, data, model = map(int, sys.argv[1:5])
    main(rank, world, data, model, sys.argv[5])
