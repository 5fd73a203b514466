"""One rank of the port's CPU parallel tests: `launch(world, jobs, workdir)`
starts `world` gloo processes of this file (each imports torch, numpy and
the port only), and each runs the named jobs in order over inputs the test
wrote to `workdir` (npz / json), writing `<job>.npz` from rank 0.

    python tests/torch_parallel_worker.py <workdir> <job> [<job> ...]

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (`launch` sets
them).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: int, jobs, workdir: str, timeout: float = 240.0) -> None:
    """Run `jobs` on `world` ranks; raises with the ranks' output if one
    fails or the launch outlives `timeout` seconds."""
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1", HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, workdir, *jobs],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=workdir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed = True
        outs.append(out.decode(errors="replace"))
        failed |= p.returncode != 0
    if failed:
        raise RuntimeError("parallel launch failed:\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))


# ── the jobs (run inside a rank) ────────────────────────────────────


def _load(workdir, name):
    import numpy as np
    with np.load(os.path.join(workdir, name)) as z:
        return {k: z[k] for k in z.files}


def _save(workdir, name, arrays):
    import numpy as np
    import torch.distributed as dist
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, name), **arrays)


def _mesh(dp=1, fsdp=1, sp=1, tp=1):
    from otter_tpu_torch.config import ParallelConfig
    from otter_tpu_torch.parallel.mesh import create_mesh
    return create_mesh(ParallelConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                       device="cpu")


def _np(t):
    """numpy of a tensor; None stays None (a full tensor that only rank 0
    gathers: `gather_full`)."""
    return None if t is None else t.detach().cpu().numpy()


def job_ring(workdir):
    """The ring over the process group against the inputs of ring.npz,
    for every case of ring.json: out and grads."""
    import torch
    from otter_tpu_torch.ops.ring_attention import ring_attention
    spec = json.load(open(os.path.join(workdir, "ring.json")))
    arrays = _load(workdir, "ring.npz")
    world = int(os.environ["WORLD_SIZE"])
    out = {}
    for case in spec:
        if case["sp"] != world:
            continue
        mesh = _mesh(sp=case["sp"])
        name = case["name"]
        q, k, v = (torch.tensor(arrays[f"{name}/{x}"], requires_grad=True)
                   for x in "qkv")
        bias = ids = None
        if f"{name}/bias" in arrays:
            bias = torch.tensor(arrays[f"{name}/bias"], requires_grad=True)
        if f"{name}/q_ids" in arrays:
            ids = (torch.tensor(arrays[f"{name}/q_ids"]),
                   torch.tensor(arrays[f"{name}/kv_ids"]))
        o = ring_attention(q, k, v, mesh=mesh, causal=case["causal"],
                           bias=bias, q_ids=None if ids is None else ids[0],
                           kv_ids=None if ids is None else ids[1],
                           ids_mode=case["ids_mode"],
                           grad_mode=case["grad_mode"])
        do = torch.tensor(arrays[f"{name}/do"])
        wrt = [q, k, v] + ([bias] if bias is not None else [])
        grads = torch.autograd.grad(o, wrt, do)
        out[f"{name}/out"] = _np(o)
        for x, g in zip("qkvb", grads):
            out[f"{name}/d{x}"] = _np(g)
    _save(workdir, f"ring_{world}.npz", out)


def _model(workdir, arch="mpt"):
    import torch
    from otter_tpu_torch.config import FuyuConfig, OtterConfig
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.fuyu import FuyuVLM
    from otter_tpu_torch.models.otter import OtterVLM
    with open(os.path.join(workdir, f"{arch}_cfg.json")) as f:
        d = json.load(f)
    flat = _load(workdir, f"{arch}_params.npz")
    if arch == "fuyu":
        model = FuyuVLM(FuyuConfig.from_dict(d), dtype=torch.float32,
                        device="cpu")
    else:
        model = OtterVLM(OtterConfig.from_dict(d), dtype=torch.float32,
                         device="cpu")
    load_flax_params(model, flat)
    return model


def job_seq_forward(workdir):
    """Logits of mpt, llama and fuyu under sequence_parallel at sp = world
    (the model whole on every rank)."""
    import torch
    from otter_tpu_torch.ops.attention import sequence_parallel
    world = int(os.environ["WORLD_SIZE"])
    mesh = _mesh(sp=world)
    out = {}
    for arch in ("mpt", "llama", "fuyu"):
        model = _model(workdir, arch)
        b = _load(workdir, f"{arch}_fwd.npz")
        with torch.no_grad(), sequence_parallel(mesh):
            if arch == "fuyu":
                logits, _ = model(
                    torch.tensor(b["input_ids"]).long(),
                    image_patches=torch.tensor(b["image_patches"]),
                    image_patches_indices=torch.tensor(
                        b["image_patches_indices"]).long())
            else:
                logits, _, _ = model(
                    torch.tensor(b["vision_x"]),
                    torch.tensor(b["input_ids"]).long(),
                    attention_mask=torch.tensor(b["attention_mask"]))
        out[arch] = _np(logits)
    _save(workdir, f"seq_forward_{world}.npz", out)


def _train_step(workdir, mesh_kw, fused_ce_chunk=0, state_bits=None,
                steps=1):
    """One sharded train step of the tiny mpt model over the global batch
    of train_batch.npz: (loss, grad_norm, full trainable params, state)."""
    import torch
    from otter_tpu_torch.parallel.mesh import shard_batch
    from otter_tpu_torch.parallel.sharding import shard_params
    from otter_tpu_torch.runtime.checkpoint import full_params
    from otter_tpu_torch.train import step as tstep
    spec = json.load(open(os.path.join(workdir, "train.json")))
    model = _model(workdir, "mpt")
    cfg = model.cfg
    mesh = _mesh(**mesh_kw)
    trainable, _ = tstep.split_params(model, cfg)
    shard_params(mesh, model)
    tx = tstep.make_optimizer(trainable, lr=spec["lr"], total_steps=10,
                              state_bits=state_bits)
    state = tstep.TrainState.create(model, cfg, tx)
    step = tstep.make_train_step(model, cfg, tx, mesh=mesh,
                                 fused_ce_chunk=fused_ce_chunk)
    batch = shard_batch(mesh, {k: torch.tensor(v) for k, v in
                               _load(workdir, "train_batch.npz").items()})
    for _ in range(steps):
        state, m = step(state, batch)
    params = full_params(state)
    return m, {k: params[k] for k in state.trainable}, state


MESHES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "sp2": dict(sp=2),
          "tp2": dict(tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2),
          "dp2_sp2": dict(dp=2, sp=2)}
# the meshes whose step takes the chunked fused cross-entropy
FUSED_CE = ("fsdp2", "dp2_sp2")


def job_train(workdir):
    """One train step on each mesh of this world size."""
    import math
    world = int(os.environ["WORLD_SIZE"])
    for name, kw in MESHES.items():
        if math.prod(kw.values()) != world:
            continue
        m, params, _ = _train_step(
            workdir, kw, fused_ce_chunk=8 if name in FUSED_CE else 0)
        out = {f"param/{k}": _np(v) for k, v in params.items()}
        out.update(loss=_np(m["loss"]), grad_norm=_np(m["grad_norm"]),
                   tokens=_np(m["tokens"]))
        _save(workdir, f"train_{name}.npz", out)


def job_fuyu_step(workdir):
    """One OtterHD full fine-tune step (`make_fuyu_train_step(mesh=)`) of
    the tiny Fuyu model at sp = world and fsdp = world: loss and every
    parameter."""
    import torch
    from otter_tpu_torch.parallel.mesh import shard_batch
    from otter_tpu_torch.parallel.sharding import shard_params
    from otter_tpu_torch.runtime.checkpoint import full_params
    from otter_tpu_torch.train import fuyu_sft
    from otter_tpu_torch.train import step as tstep
    world = int(os.environ["WORLD_SIZE"])
    lr = json.load(open(os.path.join(workdir, "fuyu.json")))["lr"]
    batch = {k: torch.tensor(v)
             for k, v in _load(workdir, "fuyu_batch.npz").items()}
    for name, kw in (("sp", dict(sp=world)), ("fsdp", dict(fsdp=world))):
        model = _model(workdir, "fuyu")
        mesh = _mesh(**kw)
        shard_params(mesh, model)
        tx = tstep.make_optimizer(
            [tstep.flax_path(n) for n, _ in model.named_parameters()],
            lr=lr, total_steps=10)
        state = fuyu_sft.fuyu_train_state(model, tx)
        step = fuyu_sft.make_fuyu_train_step(model, tx, mesh=mesh)
        state, m = step(state, shard_batch(mesh, batch))
        out = {f"param/{k}": _np(v) for k, v in full_params(state).items()}
        out["loss"] = _np(m["loss"])
        _save(workdir, f"fuyu_step_{name}{world}.npz", out)


def job_opt8(workdir):
    """8-bit Adam at fsdp = world over given gradients: the gathered int8
    moments and scales, and the parameters, against one device's."""
    import torch
    import torch.distributed as dist
    from otter_tpu_torch.parallel.sharding import local_of, shard_params
    from otter_tpu_torch.runtime.checkpoint import _full_opt, full_params
    from otter_tpu_torch.train import step as tstep
    world = int(os.environ["WORLD_SIZE"])
    grads = _load(workdir, "opt8_grads.npz")

    def run(mesh):
        model = _model(workdir, "mpt")
        trainable, _ = tstep.split_params(model, model.cfg)
        if mesh is not None:
            shard_params(mesh, model)
        tx = tstep.make_optimizer(trainable, lr=1e-3, total_steps=10,
                                  state_bits=8)
        state = tstep.TrainState.create(model, model.cfg, tx)
        lays = getattr(model, "_shard_layouts", {})
        for _ in range(2):
            for k, p in state.trainable.items():
                g = torch.tensor(grads[k])
                local = local_of(lays.get(k), g)
                p.grad = (torch.distributed.tensor.DTensor.from_local(
                    local, p.device_mesh, p.placements, shape=p.shape,
                    stride=p.stride()) if hasattr(p, "placements") else local)
            tstep.apply_grads(state, tx)
        return full_params(state), _full_opt(state), state

    p_sh, o_sh, _ = run(_mesh(fsdp=world))
    p_one, o_one, _ = run(None)
    out = {}
    for k in p_one:
        if k in o_one["mu"]:
            for key in ("mu", "nu", "mu_s", "nu_s"):
                out[f"{key}/{k}/sharded"] = _np(o_sh[key][k])
                out[f"{key}/{k}/one"] = _np(o_one[key][k])
            out[f"param/{k}/sharded"] = _np(p_sh[k])
            out[f"param/{k}/one"] = _np(p_one[k])
    dist.barrier()
    _save(workdir, "opt8.npz", out)


def job_tp_generate(workdir):
    """Greedy tokens of the tiny mpt and llama engines with parameters
    sharded at fsdp x tp = world, against the whole model's, and the KV
    cache's head count."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.parallel.sharding import shard_params
    world = int(os.environ["WORLD_SIZE"])
    out = {}
    for arch in ("mpt", "llama"):
        b = _load(workdir, f"{arch}_gen.npz")
        gen = GenerationConfig(max_new_tokens=4, do_sample=False)
        ref = OtterGenerator(_model(workdir, arch), cache_dtype=torch.float32
                             ).generate(b["vision_x"], b["input_ids"],
                                        gen=gen)
        model = _model(workdir, arch)
        kw = dict(tp=world) if world == 2 else dict(fsdp=2, tp=world // 2)
        shard_params(_mesh(**kw), model)
        eng = OtterGenerator(model, cache_dtype=torch.float32)
        toks = eng.generate(b["vision_x"], b["input_ids"], gen=gen)
        out[f"{arch}/ref"] = _np(torch.as_tensor(ref))
        out[f"{arch}/tp"] = _np(torch.as_tensor(toks))
        attn = model.lang_encoder.layers_0.attn
        out[f"{arch}/local_heads"] = _np(torch.tensor(attn.heads))
    _save(workdir, f"tp_generate_{world}.npz", out)


def job_mains(workdir):
    """sft.main at fsdp = world and pretrain.main at tp = world with
    --multi_host, over the test's YAML and shards, from the initial
    weights of the JAX trainers (sft_params.npz, pre_params.npz); sft.main
    then resumes for a second epoch. Images decode through PIL, as the
    test's JAX chains decode them."""
    from otter_tpu_torch import native
    from otter_tpu_torch.config import OtterConfig
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.train import pretrain, sft
    spec = json.load(open(os.path.join(workdir, "mains.json")))
    world = os.environ["WORLD_SIZE"]
    native.available = lambda: False
    params = _load(workdir, "sft_params.npz")
    sft.main(sft.parse_args(spec["sft"] + ["--multi_host", "--fsdp", world,
                                           "--run_name", "sft_mesh"]),
             params=params, device="cpu")
    sft.main(sft.parse_args(spec["sft"] + [
        "--multi_host", "--fsdp", world, "--run_name", "sft_mesh",
        "--num_epochs", "2", "--resume_from_checkpoint", "latest"]),
        params=params, device="cpu")
    pretrain.PRESETS["mpt1b"] = lambda: OtterConfig.tiny("mpt")
    pre = _load(workdir, "pre_params.npz")
    pretrain.init_params = lambda model, seed: load_flax_params(model, pre)
    pretrain.main(spec["pretrain"] + ["--multi_host", "--tp", world,
                                      "--run_name", "pre_mesh"],
                  device="cpu")


def main(argv):
    import torch
    torch.set_num_threads(1)
    from otter_tpu_torch.parallel.distributed import init_distributed_device
    workdir, jobs = argv[0], argv[1:]
    init_distributed_device("cpu", timeout_s=180)
    import torch.distributed as dist
    for job in jobs:
        globals()[f"job_{job}"](workdir)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
