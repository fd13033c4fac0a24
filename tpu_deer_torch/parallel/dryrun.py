"""The multi-process dry run: port of `__graft_entry__.py:dryrun_multichip`.

    python -m tpu_deer_torch.parallel.dryrun N [--platform cpu]

runs the reference's eight checks, in its order, on a world of N
processes, one device each, at the reference's tiny configuration:

  1. one train step of `DEERTrainer` on the ("data", "model") mesh (model 2
     where N is even and at least 4, else 1), batch 4·N;
  2. the CCC of the step's predictions from statistics all-reduced over
     "data" against the host's CCC of the whole batch;
  3. one step under 'fsdp', and the count of tensors split over "data";
  4. ring attention over a ("seq",) mesh of all N processes against
     attention over the whole sequence (`parallel/sequence.py`);
  5. an N-stage GPipe schedule against the sequential fold
     (`parallel/pipeline.py`);
  6. MoEFusion with its N experts split over an ("expert",) mesh against
     the replicated module (`parallel/mesh.py:expert_parallel`);
  7. where "model" > 1, a deep ensemble of "model" members with the member
     axis over "model" ('ensemble'): one step, and the count of tensors
     split over "model";
  8. the dp × tp and the fsdp states saved in the sharded format, restored
     bit for bit and stepped once more.

and prints the reference's line (the same keys). Where no process group
is running, N = 1 starts one (NCCL on the card, gloo with `--platform
cpu`) and N > 1 spawns N processes of this module on localhost (gloo with
`--platform cpu`; NCCL takes one card a process). Under torchrun, or with
TPU_DEER_MULTIPROCESS=1 and MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK
set, each process joins the group and runs its part.

On the card the ring runs the flash-attention kernels K3a-c, which take
head sizes 32 and 64: its q/k/v are [2, 2, 4·N, 32] there, [2, 2, 4·N, 8]
(the reference's) on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_deer_torch.device import DeviceLike, resolve_device

# __graft_entry__.py:139-142, the reference's tiny configuration.
MODEL = dict(audio_dim=16, video_dim=16, text_dim=16, encoder_dim=32,
             fusion_dim=64, attention_heads=4, encoder_layers=1, dropout=0.1)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _max_over_world(x: float, device) -> float:
    t = torch.tensor(float(x), dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _shared_dir(device) -> str:
    """A temporary directory that every process of the world writes into
    (rank 0's, broadcast); the caller removes it."""
    path = [tempfile.mkdtemp(prefix="dryrun_ckpt_") if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(path, src=0, device=device)
    return path[0]


def _line(r: dict) -> str:
    return (f"dryrun_multichip OK: mesh={r['mesh']} step={r['step']} "
            f"loss={r['loss']:.4f} psum_ccc={r['psum_ccc']:.4f} "
            f"(host {r['host_ccc']:.4f}) fsdp_loss={r['fsdp_loss']:.4f} "
            f"fsdp_sharded_leaves={r['fsdp_sharded_leaves']} "
            f"sp_ring_diff={r['sp_ring_diff']:.2e} "
            f"pp_gpipe_diff={r['pp_gpipe_diff']:.2e} "
            f"ep_moe_diff={r['ep_moe_diff']:.2e} "
            f"ens_loss={r['ens_loss']:.4f} "
            f"ens_sharded_leaves={r['ens_sharded_leaves']} "
            f"ckpt_round_trip=(tp:{r['ckpt_round_trip'][0]},"
            f"fsdp:{r['ckpt_round_trip'][1]})")


def training_config(n: int):
    """The dry run's training configuration at a world of n (batch 4·n,
    divisible by the "data" axis)."""
    from tpu_deer_torch.train.trainer import TrainingConfig

    return TrainingConfig(batch_size=4 * n, num_epochs=1, warmup_epochs=0,
                          scheduler="constant")


def dryrun_batch(n: int) -> dict:
    """The dry run's global batch at a world of n: the first unshuffled
    batch of the synthetic train split (__graft_entry__.py:146-152)."""
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits

    splits = make_synthetic_splits(SyntheticConfig(
        n_train=4 * n, n_val=4 * n, n_test=0, audio_dim=16, video_dim=16,
        text_dim=16))
    return next(iter(BatchIterator(ArrayDataset(splits["train"], "synthetic"),
                                   4 * n, shuffle=False).epoch(0)))


def run_checks(runtime, init: Optional[dict] = None,
               ensemble_init: Optional[dict] = None) -> dict:
    """The eight checks on the running world (`runtime`: this process's
    `DistributedRuntime`); every process returns the results, rank 0 prints
    the line. `init`: the flagship's state_dict to start from (default the
    port's seed-0 init); `ensemble_init`: the ensemble's stacked one
    (default `create_deer_ensemble(seed=0)`)."""
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_deer_torch.core.metrics import ccc_from_stats, ccc_np
    from tpu_deer_torch.kernels.flash_attention import flash_attention_plain
    from tpu_deer_torch.models.deer_model import (
        DEERModelConfig,
        create_complete_deer_model,
    )
    from tpu_deer_torch.models.fusion import MoEFusion
    from tpu_deer_torch.models.layers import init_flax_style_
    from tpu_deer_torch.parallel.dist_metrics import global_ccc_stats
    from tpu_deer_torch.parallel.mesh import (
        MeshConfig,
        expert_parallel,
        mesh_shape,
        shard_batch,
    )
    from tpu_deer_torch.parallel.pipeline import pipeline_sharded
    from tpu_deer_torch.parallel.sequence import ring_attention_sharded
    from tpu_deer_torch.train.checkpoint import CheckpointManager
    from tpu_deer_torch.train.ensemble import EnsembleTrainer, create_deer_ensemble
    from tpu_deer_torch.train.trainer import DEERTrainer

    device = runtime.device
    n = runtime.process_count
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = runtime.global_mesh(MeshConfig(data=n // model_axis, model=model_axis))
    model_cfg = DEERModelConfig(**MODEL)

    def model_from_init():
        model = create_complete_deer_model(model_cfg, seed=0, device=device)
        if init is not None:
            model.load_state_dict(init)
        return model

    tcfg = training_config(n)

    def trainer_for(mode):
        return DEERTrainer(model_from_init(),
                           dataclasses.replace(tcfg, param_sharding=mode),
                           steps_per_epoch=1, mesh=mesh, runtime=runtime)

    batch = dryrun_batch(n)
    local = shard_batch(batch, mesh, device)
    out = {"mesh": mesh_shape(mesh)}

    # 1) one train step on the mesh.
    trainer = trainer_for("tp")
    out["loss"] = float(trainer._train_step(local, 1.0, 1.0)["loss"])
    out["step"] = trainer.step
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"non-finite loss {out['loss']} in the dry run")

    # 2) CCC from statistics all-reduced over "data" against the host's.
    mu_local = trainer._eval_step(local)["mu"]
    labels = local["labels"]
    stats = global_ccc_stats(labels, torch.as_tensor(mu_local, device=device),
                             group=mesh.get_group("data"))
    out["psum_ccc"] = float(ccc_from_stats(stats))
    mu_all = trainer._eval_step({k: torch.as_tensor(v, device=device)
                                 for k, v in batch.items()})["mu"]
    out["host_ccc"] = float(ccc_np(batch["labels"].ravel(), mu_all.ravel()))
    if abs(out["psum_ccc"] - out["host_ccc"]) >= 1e-4:
        raise AssertionError(f"distributed CCC {out['psum_ccc']} != host CCC "
                             f"{out['host_ccc']}")

    # 3) FSDP: one step; the tensors split over "data". (The reference
    # counts the leaves of its step's output state whose sharding names
    # "data": 41 at data 4, where its rules give 39 as these do.)
    trainer_f = trainer_for("fsdp")
    out["fsdp_loss"] = float(trainer_f._train_step(local, 1.0, 1.0)["loss"])
    out["fsdp_sharded_leaves"] = sum(
        "data" in spec for spec in trainer_f._layout.specs.values())
    if not np.isfinite(out["fsdp_loss"]):
        raise AssertionError(f"non-finite FSDP loss {out['fsdp_loss']}")
    if mesh_shape(mesh)["data"] > 1 and not out["fsdp_sharded_leaves"]:
        raise AssertionError("FSDP left every param replicated")

    # 4) ring attention over a "seq" axis of every process.
    rng = np.random.default_rng(0)
    head = 32 if device.type == "cuda" else 8  # K3's head sizes on the card
    seq_mesh = init_device_mesh(device.type, (n,), mesh_dim_names=("seq",))
    q, kk, vv = (torch.tensor(rng.standard_normal((2, 2, 4 * n, head)),
                              dtype=torch.float32, device=device)
                 for _ in range(3))
    ring = ring_attention_sharded(seq_mesh, q, kk, vv)
    rank = seq_mesh.get_local_rank("seq")
    full = flash_attention_plain(q, kk, vv)[:, :, 4 * rank:4 * (rank + 1)]
    out["sp_ring_diff"] = _max_over_world((ring - full).abs().max().item(), device)
    if out["sp_ring_diff"] >= 1e-4:
        raise AssertionError(f"ring attention diverged: {out['sp_ring_diff']}")

    # 5) GPipe over n stages against the sequential fold.
    stage_mesh = init_device_mesh(device.type, (n,), mesh_dim_names=("stage",))
    pp = {"w": torch.tensor(rng.standard_normal((n, 8, 8)) * 0.1,
                            dtype=torch.float32, device=device),
          "b": torch.tensor(rng.standard_normal((n, 8)) * 0.1,
                            dtype=torch.float32, device=device)}
    stage_fn = lambda p, h: h + torch.tanh(h @ p["w"] + p["b"])
    x_pp = torch.tensor(rng.standard_normal((4 * n, 8)), dtype=torch.float32,
                        device=device)
    piped = pipeline_sharded(stage_mesh, stage_fn, pp, x_pp,
                             num_microbatches=2 * n)
    h_seq = x_pp
    for i in range(n):
        h_seq = stage_fn({"w": pp["w"][i], "b": pp["b"][i]}, h_seq)
    out["pp_gpipe_diff"] = _max_over_world((piped - h_seq).abs().max().item(),
                                           device)
    if out["pp_gpipe_diff"] >= 1e-4:
        raise AssertionError(f"pipeline diverged: {out['pp_gpipe_diff']}")

    # 6) MoEFusion with its experts split over an "expert" axis.
    moe = MoEFusion((16, 16), 32, num_experts=n, expert_hidden=16)
    init_flax_style_(moe, torch.Generator().manual_seed(0))
    moe = moe.to(device)
    mods = [torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32,
                         device=device) for _ in range(2)]
    with torch.no_grad():
        moe_ref = moe(mods)
        ep_mesh = init_device_mesh(device.type, (n,), mesh_dim_names=("expert",))
        moe_sharded = expert_parallel(moe, ep_mesh)(mods)
    out["ep_moe_diff"] = _max_over_world(
        (moe_sharded - moe_ref).abs().max().item(), device)
    if out["ep_moe_diff"] >= 1e-4:
        raise AssertionError(f"expert-sharded MoE diverged: {out['ep_moe_diff']}")

    # 7) a deep ensemble with the member axis over "model".
    out["ens_loss"], out["ens_sharded_leaves"] = float("nan"), 0
    if model_axis > 1:
        structure_model, stack = create_deer_ensemble(
            model_cfg, n_members=model_axis, seed=0, device=device)
        if ensemble_init is not None:
            stack = {k: v.to(device) for k, v in ensemble_init.items()}
        trainer_e = EnsembleTrainer(
            structure_model, stack,
            dataclasses.replace(tcfg, param_sharding="ensemble"),
            steps_per_epoch=1, mesh=mesh, runtime=runtime)
        out["ens_loss"] = float(trainer_e._train_step(local, 1.0, 1.0)["loss"])
        out["ens_sharded_leaves"] = sum(
            "model" in spec for spec in trainer_e._layout.specs.values())
        if not np.isfinite(out["ens_loss"]):
            raise AssertionError(f"non-finite ensemble loss {out['ens_loss']}")
        if not out["ens_sharded_leaves"]:
            raise AssertionError("ensemble member axis left replicated")

    # 8) the sharded checkpoint: save, restore bit for bit, step again.
    def round_trip(tr, tag):
        root = _shared_dir(device)
        try:
            ckpt = CheckpointManager(root)
            state = tr.state_dict()
            path = ckpt.save(state, step=tr.step)
            ckpt.wait()
            if not os.path.exists(os.path.join(path, "manifest.json")):
                raise AssertionError(f"{tag}: the state was not saved in the "
                                     "sharded format")
            restored = ckpt.restore(step=tr.step, template=state)
            for k, v in state["model"].items():
                if not torch.equal(restored["model"][k].to_local(), v.to_local()):
                    raise AssertionError(f"{tag}: restored {k} differs")
            before = tr.step
            tr.load_state_dict(restored)
            loss = float(tr._train_step(local, 1.0, 1.0)["loss"])
            if not np.isfinite(loss) or tr.step != before + 1:
                raise AssertionError(f"{tag}: the step after the restore")
            dist.barrier()
        finally:
            if dist.get_rank() == 0:
                import shutil

                shutil.rmtree(root, ignore_errors=True)
        return tr.step

    out["ckpt_round_trip"] = (round_trip(trainer, "dp×tp"),
                              round_trip(trainer_f, "fsdp"))
    out["line"] = _line(out)
    if dist.get_rank() == 0:
        print(out["line"], flush=True)
    return out


def dryrun_multichip(n_devices: int, init: Optional[dict] = None,
                     ensemble_init: Optional[dict] = None, *,
                     device: DeviceLike = None) -> dict:
    """The dry run on a world of `n_devices` processes (see the module
    docstring); returns rank 0's results. In a running process group its
    size must be `n_devices`. `device`: None = the CUDA card(s), "cpu" =
    gloo processes on the CPU."""
    from tpu_deer_torch.parallel.runtime import (
        RuntimeConfig,
        initialize_runtime,
        shutdown_runtime,
    )

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the running group has {dist.get_world_size()} "
                             f"processes, not {n_devices}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        from tpu_deer_torch.parallel.runtime import DistributedRuntime

        return run_checks(DistributedRuntime(True, dev), init, ensemble_init)
    if n_devices == 1:
        runtime = initialize_runtime(
            RuntimeConfig(coordinator_address=f"127.0.0.1:{_free_port()}",
                          num_processes=1, process_id=0), device=device)
        try:
            return run_checks(runtime, init, ensemble_init)
        finally:
            shutdown_runtime(runtime)
    if init is not None or ensemble_init is not None:
        raise ValueError("an init state_dict needs a running process group "
                         "(spawned processes start from the seed-0 init)")
    return _spawn(n_devices, device)


def _spawn(n: int, device: DeviceLike) -> dict:
    """n processes of this module on localhost; rank 0's results."""
    platform = resolve_device(device).type
    with tempfile.TemporaryDirectory() as root:
        result = os.path.join(root, "rank0.json")
        env = {**os.environ, "TPU_DEER_MULTIPROCESS": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1"}
        argv = [sys.executable, "-m", "tpu_deer_torch.parallel.dryrun", str(n),
                "--platform", platform, "--result", result]
        procs = [subprocess.Popen(argv, env={**env, "RANK": str(r),
                                             "LOCAL_RANK": str(r)})
                 for r in range(n)]
        try:
            codes = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"dry-run processes exited with {codes}")
        with open(result) as f:
            return json.load(f)


def main(argv=None) -> int:
    from tpu_deer_torch.parallel.runtime import (
        RuntimeConfig,
        initialize_runtime,
        shutdown_runtime,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="processes in the world")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--result", help="where rank 0 writes its results (JSON)")
    args = p.parse_args(argv)
    if (os.environ.get("TPU_DEER_MULTIPROCESS") == "1"
            or "TORCHELASTIC_RUN_ID" in os.environ):  # under torchrun
        runtime = initialize_runtime(RuntimeConfig(multiprocess=True),
                                     device=args.platform)
        try:
            if runtime.process_count != args.n:
                raise ValueError(f"{runtime.process_count} processes, not {args.n}")
            out = run_checks(runtime)
        finally:
            shutdown_runtime(runtime)
    else:
        out = dryrun_multichip(args.n, device=args.platform)
    if args.result and int(os.environ.get("RANK", 0)) == 0:
        with open(args.result, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
