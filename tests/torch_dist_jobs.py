"""Multi-process jobs of the port's parallel tests, and their launcher.

`spawn(job, world, tmp)` starts `world` processes of this module on the CPU
(one torch thread each), each bringing up a gloo group on a FileStore under
`tmp` (no port to race for between test workers), running `JOBS[job]` and
saving its result to `tmp/out<rank>.pt`; the launcher returns the results.
The jobs import torch and the port only: the tests compare them with the
JAX package and the one-process port in the pytest process.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def spawn(job: str, world: int, tmp, payload=None, timeout: int = 600) -> list:
    """Run `job` in `world` processes; their results, rank order."""
    import torch

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "payload.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_jobs", job, str(r),
                               str(world), str(tmp)], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {job} exited {p.returncode}:\n{out[-6000:]}")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


def _init(rank: int, world: int, tmp: Path, name: str = "store") -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp / name}", rank=rank,
                            world_size=world)


def _forward(bdef, params, statics, inp):
    return bdef.forward(params, statics, inp["x"], inp["cond"], inp["text"], inp["time"],
                        lengths=inp["lengths"], dtype=inp["x"].dtype)


def tp_forwards(rank: int, world: int, tmp: Path, payload: dict) -> dict:
    """Each case's forward at a 1 x 2 mesh (this rank's shards and heads);
    quantize of the sharded tree against the shard of the quantized one."""
    from f5tts_tpu_torch.config import ModelArch
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.ops.quant import quantize_dit_params
    from f5tts_tpu_torch.parallel.mesh import make_mesh, shard_params

    _init(rank, world, tmp)
    mesh = make_mesh(1, world)
    out = {}
    for name, case in payload["cases"].items():
        bdef = BACKBONES[case["backbone"]]
        statics = bdef.statics_cls(ModelArch(**case["arch"]), tp=mesh.tp)
        out[name] = _forward(bdef, shard_params(case["params"], mesh), statics, payload["inputs"])
    fused = payload["cases"]["dit"]["params"]
    q_local = quantize_dit_params(shard_params(fused, mesh), tp=mesh.tp)
    local_q = shard_params(quantize_dit_params(fused), mesh)
    out["quantized_shards_equal"] = all(
        a.dtype == b.dtype and torch_equal(a, b)
        for a, b in zip(m.tree_leaves(q_local), m.tree_leaves(local_q)))
    return out


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def _run_steps(step, state, batches, seeds, accum: int = 1):
    """Updates over `batches` (this rank's rows), `accum` micro-batches
    each: losses and grad norms."""
    import torch

    from f5tts_tpu_torch.models import modules as m

    losses, norms = [], []
    for u in range(len(batches) // accum):
        loss_sum, g_sum = None, None
        for k in range(accum):
            mel, text, lens = batches[u * accum + k]
            gen = torch.Generator().manual_seed(seeds[u * accum + k])
            loss, grads = step.grad_step(state.params, mel, text, lens, generator=gen)
            if g_sum is None:
                loss_sum, g_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(m.tree_leaves(g_sum), m.tree_leaves(grads))
        if accum > 1:
            torch._foreach_div_(m.tree_leaves(g_sum), float(accum))
            loss_sum = loss_sum / accum
        state, metrics = step.apply_step(state, loss_sum, g_sum)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


def make_step(statics, kw: dict, mesh=None, backbone: str = "DiT"):
    """The train step of `kw` (optimizer, CFM and EMA settings), f32."""
    import torch

    from f5tts_tpu_torch.config import CFMConfig
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.train.step import make_optimizer, make_train_step

    return make_train_step(statics, make_optimizer(*kw["opt"]), CFMConfig(**kw["cfm"]),
                           dtype=torch.float32, backbone=BACKBONES[backbone], mesh=mesh,
                           **kw["ema"])


def steps(rank: int, world: int, tmp: Path, payload: dict) -> dict:
    """Two updates of the DiT step at 2 x 1 (replicated state and ZeRO-1)
    and 1 x 2, of the qk-norm DiT and MMDiT at 1 x 2, ZeRO-1 with gradient
    accumulation and with bf16 state, LoRA
    (ZeRO-1 with accumulation and a checkpoint between updates; TP), and
    the Trainer at 2 x 1 with ZeRO-1 saving its checkpoints."""
    import torch
    import torch.distributed as dist

    from f5tts_tpu_torch.config import ModelArch, TrainConfig
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.parallel.mesh import (batch_sharding, dit_param_specs,
                                               gather_train_state, make_mesh, shard_params,
                                               shard_train_state)
    from f5tts_tpu_torch.train import lora as tl
    from f5tts_tpu_torch.train.dataset import InMemoryDataset
    from f5tts_tpu_torch.train.step import init_train_state
    from f5tts_tpu_torch.train.trainer import Trainer

    _init(rank, world, tmp)
    arch = ModelArch(**payload["arch"])
    params, batch, micro = payload["params"], payload["batch"], payload["micro"]
    meshes = {"dp": make_mesh(world, 1), "tp": make_mesh(1, world)}
    out = {}

    def rows_of(mesh, b):
        rows = batch_sharding(mesh, b[0].shape[0])
        return tuple(t[rows] for t in b)

    def dit_run(name, mesh, zero1, batches, seeds, accum=1, sdt=None):
        step = make_step(dit.DiTStatics(arch, tp=mesh.tp), payload["step_kw"], mesh)
        state = shard_train_state(init_train_state(params, moment_dtype=sdt, ema_dtype=sdt),
                                  mesh, zero1)
        if zero1:
            out[name + "_shard"] = (state.mu.numel(), state.nu.numel(), state.ema.numel(),
                                    state.mu.dtype)
        state, losses, norms = _run_steps(step, state, [rows_of(mesh, b) for b in batches],
                                          seeds, accum)
        out[name] = {"losses": losses, "norms": norms, "state": gather_train_state(state)}

    two = [batch, batch]
    dit_run("dp", meshes["dp"], False, two, payload["seeds"])
    dit_run("z1", meshes["dp"], True, two, payload["seeds"])
    dit_run("tp", meshes["tp"], False, two, payload["seeds"])
    dit_run("z1_accum", meshes["dp"], True, micro, payload["micro_seeds"], accum=2)
    dit_run("z1_bf16", meshes["dp"], True, two, payload["seeds"], sdt=torch.bfloat16)

    # qk-norm at 1 x 2: the norm weights are whole on each rank and act on
    # its heads only
    for name, case in payload["qk_norm"].items():
        mesh = meshes["tp"]
        statics = BACKBONES[case["backbone"]].statics_cls(ModelArch(**case["arch"]), tp=mesh.tp)
        step = make_step(statics, payload["step_kw"], mesh, case["backbone"])
        state = shard_train_state(init_train_state(case["params"]), mesh, zero1=False)
        state, losses, norms = _run_steps(step, state, two, payload["seeds"])
        out["qk_" + name] = {"losses": losses, "norms": norms, "state": gather_train_state(state),
                             "local_params": state.params}

    # LoRA: ZeRO-1 with accumulation and a checkpoint between the updates
    lcfg = tl.LoRAConfig(rank=4)
    for name, mesh, zero1 in (("lora_z1", meshes["dp"], True), ("lora_tp", meshes["tp"], False)):
        base_specs = dit_param_specs(params)
        base = shard_params(params, mesh, base_specs)
        step = tl.make_lora_train_step(base, dit.DiTStatics(arch, tp=mesh.tp),
                                       tl.AdamWHParams(5e-3), lcfg, payload["lora_cfm"],
                                       dtype=torch.float32, mesh=mesh)
        lora, opt = tl.shard_lora_state(payload["lora"], tl.init_lora_opt_state(payload["lora"]),
                                        base_specs, mesh, zero1)
        for u in range(2):
            g_sum = None
            for k in range(2):
                mel, text, lens = rows_of(mesh, micro[2 * u + k])
                gen = torch.Generator().manual_seed(payload["micro_seeds"][2 * u + k])
                loss, grads = step.loss_and_grads(lora, mel, text, lens, generator=gen)
                if g_sum is None:
                    g_sum = grads
                else:
                    torch._foreach_add_(m.tree_leaves(g_sum), m.tree_leaves(grads))
            torch._foreach_div_(m.tree_leaves(g_sum), 2.0)
            step.apply(lora, opt, g_sum)
            if u == 0 and zero1:  # a checkpoint, gathered to rank 0, read back by every rank
                full_lora, full_opt = tl.gather_lora_state(lora, opt)
                path = tmp / "lora_ckpt.pt"
                if rank == 0:
                    torch.save({"lora": full_lora, "mu": full_opt.mu, "nu": full_opt.nu,
                                "count": full_opt.count}, path)
                dist.barrier()
                ck = torch.load(path, weights_only=True)
                lora, opt = tl.shard_lora_state(
                    ck["lora"], tl.LoRAOptState(ck["mu"], ck["nu"], ck["count"]), base_specs,
                    mesh, zero1)
                out[name + "_ckpt_step"] = opt.count
        full_lora, full_opt = tl.gather_lora_state(lora, opt)
        out[name] = {"lora": full_lora, "mu": full_opt.mu, "nu": full_opt.nu}

    # the Trainer at 2 x 1 under ZeRO-1: two updates, its checkpoints
    mels, texts = payload["trainer_data"]
    cfg = TrainConfig(**payload["trainer_cfg"], save_dir=str(tmp / "trainer"))
    tr = Trainer(params, dit.DiTStatics(arch), cfg, tokenizer="char",
                 vocab_char_map=payload["vocab"], dtype=torch.float32, device="cpu",
                 logger=None, mesh=meshes["dp"], zero1=True, total_updates=20)
    out["trainer_metrics"] = tr.train(InMemoryDataset(mels, texts), max_updates=2, log_every=1)
    out["trainer_step"] = tr.state.step
    return out


def multihost(rank: int, world: int, tmp: Path, payload: dict) -> dict:
    """multihost_sim, scaling_bench and train_cli --mesh_data, each over its
    own group of these processes."""
    from f5tts_tpu_torch.eval import scaling_bench
    from f5tts_tpu_torch.scripts import multihost_sim
    from f5tts_tpu_torch.train import train_cli

    out = {"sim": multihost_sim.run(rank, world, f"file://{tmp / 'sim'}", "cpu")}
    out["sim_line"] = multihost_sim.result_line(out["sim"])
    out["scaling"] = scaling_bench.run(
        device="cpu", init=f"file://{tmp / 'scaling'}", rank=rank, world_size=world, reps=2,
        arch_overrides=payload["scaling_arch"], seq_frames=128)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    out["train_cli"] = train_cli.main(payload["train_cli_argv"] + [
        "--device", "cpu", "--mesh_data", str(world), "--dist_init", f"file://{tmp / 'cli'}"])
    return out


JOBS = {"tp_forwards": tp_forwards, "steps": steps, "multihost": multihost}


def main() -> None:
    import torch

    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    payload = torch.load(tmp / "payload.pt", weights_only=False)
    result = JOBS[job](rank, world, tmp, payload)
    torch.save(result, tmp / f"out{rank}.pt")


if __name__ == "__main__":
    main()
