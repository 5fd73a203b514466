"""The port's parallel layer (`otter_tpu_torch/parallel/`) against the JAX
package's (`otter_tpu/parallel/`): the env scan, the mesh's shape rules,
the partition specs, the dtype policy, the timing helper, and, in gloo
processes on the CPU (`torch_parallel_worker.py`: each rank imports torch
and the port only), one sharded train step at dp2, fsdp2, sp2, tp2 and two
composed world-4 meshes against JAX's step over the same global batch,
the 8-bit Adam's moments at fsdp2 against one device's, tensor-parallel
generation against the JAX engine's and the whole model's, and
`sft.main` / `pretrain.main` with --multi_host against the JAX trainers'
`main`s from the same initial weights.

Tolerances: the train step at the JAX test's `atol=3e-4, rtol=3e-3`
(`tests/test_seq_parallel.py`); its loss and grad norm within 1e-5 and
1e-4 relative, and the mains' losses within 1e-4 relative (f32, only the
order of sums differs); the 8-bit moments exactly; generated tokens
exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from otter_tpu.parallel import distributed as jdist
from otter_tpu.parallel import mesh as jmesh
from otter_tpu.parallel import precision as jprec
from otter_tpu.parallel import sharding as jshard
from otter_tpu.train import step as jstep
from otter_tpu_torch.config import ParallelConfig
from otter_tpu_torch.parallel import distributed as tdist
from otter_tpu_torch.parallel import mesh as tmesh
from otter_tpu_torch.parallel import precision as tprec
from otter_tpu_torch.parallel import sharding as tshard
from otter_tpu_torch.runtime.timing import force_sync, time_fn
from torch_parallel_worker import launch
from torch_parity_helpers import (fuyu_pair, jax_tiny, jax_tiny_train,
                                  train_batch)

LR = 1e-3
TRAIN_MESHES = ["dp2", "fsdp2", "sp2", "tp2", "fsdp2_tp2", "dp2_sp2"]


# ── in-process: the env scan, the shape rules, the specs ─────────────

ENV_CASES = [
    {},
    {"LOCAL_RANK": "1", "RANK": "3", "WORLD_SIZE": "4"},
    {"PMI_RANK": "2", "PMI_SIZE": "8", "MPI_LOCALRANKID": "0"},
    {"SLURM_LOCALID": "1", "SLURM_PROCID": "5", "SLURM_NTASKS": "16"},
    {"OMPI_COMM_WORLD_LOCAL_RANK": "2", "OMPI_COMM_WORLD_RANK": "6",
     "OMPI_COMM_WORLD_SIZE": "8"},
    {"LOCAL_RANK": "0", "SLURM_LOCALID": "3", "RANK": "1",
     "SLURM_PROCID": "9", "WORLD_SIZE": "2", "SLURM_NTASKS": "12"},
]


@pytest.mark.parametrize("env", ENV_CASES)
def test_world_info_from_env_matches_jax(env, monkeypatch):
    for v in {k for e in ENV_CASES for k in e}:
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tdist.world_info_from_env() == jdist.world_info_from_env()


MESH_CASES = [(8, (1, -1, 1, 1)), (8, (2, -1, 2, 1)), (8, (1, 2, 2, 2)),
              (4, (1, -1, 1, 4)), (8, (2, 2, 2, 2)), (6, (1, -1, 4, 1)),
              (8, (1, 3, 1, 1)), (1, (1, -1, 1, 1))]


@pytest.mark.parametrize("n,shape", MESH_CASES)
def test_mesh_shape_rules_and_errors_match_jax(n, shape):
    """`mesh_shape` gives the shape JAX's `create_mesh` builds over n
    devices, or raises JAX's ValueError with its message."""
    from otter_tpu.config import ParallelConfig as JCfg
    dp, fsdp, sp, tp = shape
    try:
        jm = jmesh.create_mesh(JCfg(dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                               jax.devices()[:n])
        want = tuple(jm.shape[a] for a in jmesh.MESH_AXES)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("*", r"\*")):
            tmesh.mesh_shape(ParallelConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp),
                             n)
        return
    assert tmesh.mesh_shape(
        ParallelConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp), n) == want


@pytest.mark.parametrize("n,world", [(8, 4), (6, 4), (4, 1), (1, 2)])
def test_batch_rows_split_or_replicate(n, world):
    rows = [np.arange(n)[tmesh.batch_rows(n, r, world)]
            for r in range(world)]
    if n % world:
        assert all(np.array_equal(r, np.arange(n)) for r in rows)
    else:
        np.testing.assert_array_equal(np.concatenate(rows), np.arange(n))


def test_create_mesh_raises_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.create_mesh(ParallelConfig(), device="cpu")


def test_a_mesh_without_cuda_raises_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.distributed_device(None)
    assert tdist.distributed_device("cpu").type == "cpu"


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def jax_vlm(arch: str, seed: int = 0):
    """(cfg, model, params, flat) of a tiny f32 OtterVLM of `arch` as the
    trainer sees it (`jax_tiny_train` for mpt), tanh gates away from 0."""
    from otter_tpu import config as jcfg
    from otter_tpu.models.otter import OtterVLM
    if arch == "mpt":
        return jax_tiny_train(seed)
    cfg = jcfg.OtterConfig.tiny(arch)
    model = OtterVLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 1, 1, 3, 28, 28)),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    flat = _flat(params)
    rng = np.random.default_rng(seed + 200)
    for k in flat:
        if k.endswith(("attn_gate", "ff_gate")):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return cfg, model, params, flat


def _trees():
    return {"mpt": jax_tiny_train()[3], "mpt_int8": jax_tiny()[3],
            "llama": jax_vlm("llama")[3], "fuyu": _flat(fuyu_pair()[2])}


@pytest.mark.parametrize("arch", ["mpt", "mpt_int8", "llama", "fuyu"])
def test_param_specs_match_jax(arch):
    """For every path of the tiny trees, the port's spec is the tuple JAX's
    `param_specs` gives, and `_safe_spec` drops the same axes on an
    8-device mesh of each shape."""
    from otter_tpu.config import ParallelConfig as JCfg
    flat = _trees()[arch]
    tree = traverse_util.unflatten_dict(
        {k: np.zeros(v.shape, np.int8) for k, v in flat.items()}, sep="/")
    jspecs = {"/".join(k): v for k, v in traverse_util.flatten_dict(
        jshard.param_specs(tree)).items()}
    ours = tshard.param_specs(flat)
    assert sorted(ours) == sorted(jspecs)
    for k in flat:
        assert tuple(ours[k]) == tuple(jspecs[k]), k
    for shape in ((1, 2, 2, 2), (1, 8, 1, 1), (2, 1, 1, 4)):
        jm = jmesh.create_mesh(JCfg(*shape), jax.devices()[:8])
        sizes = dict(zip(tmesh.MESH_AXES, shape))
        for k, v in flat.items():
            assert tuple(tshard._safe_spec(ours[k], v.shape, sizes)) == \
                tuple(jshard._safe_spec(jspecs[k], v.shape, jm)), (k, shape)


def test_int8_frozen_tensors_stay_whole_as_in_jax():
    """The int8 kernels have no "/kernel" path: P(), and they are buffers,
    which `fully_shard` never shards."""
    from torch_parity_helpers import torch_tiny
    model = torch_tiny()
    specs = tshard.param_specs(model)
    buffers = {k.replace(".", "/") for k, _ in model.named_buffers()}
    q = [k for k in specs if k.endswith("kernel_q")]
    assert q and all(k in buffers and specs[k] == () for k in q)


def test_cast_params_and_param_bytes_match_jax():
    flat = jax_tiny_train()[3]
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jcast = {"/".join(k): v for k, v in traverse_util.flatten_dict(
        jprec.cast_params(tree)).items()}
    ours = tprec.cast_params({k: torch.tensor(v) for k, v in flat.items()})
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    assert sorted(ours) == sorted(jcast)
    for k, v in ours.items():
        assert names[v.dtype] == str(jcast[k].dtype), k
    assert tprec.param_bytes(ours) == jprec.param_bytes(jcast)


LAYOUTS = [((10, 6), {0: [5, 6, 7, 8, 9]}), ((10, 6), {1: [1, 2, 4]}),
           ((7, 9), {0: [0, 1, 2, 3], 1: [0, 3, 4, 8]}),
           ((3, 4, 5), {1: [1, 3]}), ((12,), {0: list(range(6, 12))})]


@pytest.mark.parametrize("shape,index", LAYOUTS)
def test_global_flat_index_and_local_count_below(shape, index):
    """A shard's global row-major indices rise in its own row-major order,
    a range of them is the slice of the whole, and `local_count_below`
    counts those under every bound (the 8-bit Adam's chunk edges)."""
    import math
    lay = tshard.ShardLayout(shape, {d: torch.tensor(i)
                                     for d, i in index.items()})
    local = [len(index[d]) if d in index else n for d, n in enumerate(shape)]
    g = tshard.global_flat_index(lay, local)
    full = torch.arange(math.prod(shape)).view(shape)
    torch.testing.assert_close(g, tshard.local_of(lay, full).reshape(-1))
    torch.testing.assert_close(tshard.global_flat_index(lay, local, 2, 5),
                               g[2:5])
    for bound in range(math.prod(shape) + 3):
        assert tshard.local_count_below(lay, local, bound) == int(
            (g < bound).sum()), bound


def test_time_fn_is_the_median_of_synced_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = time_fn(fn, torch.ones(4), iters=5, warmup=2)
    assert len(calls) == 7 and 0 <= t < 1.0
    force_sync({"a": [None, torch.ones(1)]})   # nothing queued on the CPU


# ── in gloo processes ───────────────────────────────────────────────


def write_model(d, arch, flat, cfg):
    np.savez(os.path.join(d, f"{arch}_params.npz"), **flat)
    with open(os.path.join(d, f"{arch}_cfg.json"), "w") as f:
        f.write(cfg.to_json())


def _mains_spec(d):
    """A data YAML, a tokenizer directory and shards, and the argv of the
    two mains over them."""
    import chip_smoke
    from test_torch_pretrain import _argv, _write_shards
    from test_torch_sft import _tokenizer_dir
    from pathlib import Path
    tmp = Path(d)
    tok_dir, custom = _tokenizer_dir(tmp)
    yaml_path = chip_smoke.write_train_data(str(tmp / "data"), 0, n_single=4,
                                            n_context=2, image_size=32,
                                            long=False)
    sft_argv = ["--training_data_yaml", yaml_path, "--tokenizer", tok_dir,
                "--model_config", "tiny", "--customized_config", custom,
                "--precision", "fp32", "--batch_size", "2",
                "--patch_image_size", "28", "--max_seq_len", "128",
                "--learning_rate", "1e-3", "--warmup_steps", "0",
                "--logging_steps", "1", "--fused_ce_chunk", "16",
                "--workers", "1", "--save_hf_model", "--gradient_checkpointing",
                "--external_save_dir", d]
    from otter_tpu_torch.config import OtterConfig
    ptok = chip_smoke.write_tokenizer(str(tmp / "ptok"),
                                      OtterConfig.tiny("mpt"))
    laion, mmc4 = _write_shards(d)
    pre_argv = _argv(tmp, laion, mmc4, ptok)[:-2]   # the run name follows
    return sft_argv, pre_argv


def _gen_inputs(arch):
    """Two prompts of 10 tokens, each an image first."""
    rng = np.random.default_rng(5 if arch == "mpt" else 6)
    ids = rng.integers(5, 200, (2, 10)).astype(np.int32)
    ids[:, 0] = jax_vlm(arch)[0].media_token_id
    return {"vision_x": rng.standard_normal((2, 1, 1, 3, 28, 28)).astype(
        np.float32), "input_ids": ids}


def _jax_init(model, seed):
    vx = jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32)
    return _flat(jax.jit(model.init)(jax.random.PRNGKey(seed), vx,
                                     jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_sft_args(argv):
    from otter_tpu.train import args as jargs
    return jargs.parse_args([a for a in argv if a != "--save_hf_model"])


@functools.lru_cache(maxsize=None)
def _jax_sft_init(argv: tuple):
    """The JAX SFT trainer's initial weights for `argv` (its `main`'s
    init), which the port's mesh run starts from."""
    from otter_tpu.train import sft as jsft
    args = _jax_sft_args(argv)
    return _jax_init(jsft.build_model_and_config(args)[0], args.seed)


@functools.lru_cache(maxsize=None)
def _jax_pretrain_init(seed=42):
    """The JAX pretrainer's initial weights of the tiny MPT model (its
    `train`'s init at the default seed, 28-pixel patches)."""
    from otter_tpu import config as jcfg
    from otter_tpu.models.otter import OtterVLM
    cfg = jcfg.OtterConfig.tiny("mpt").replace(
        use_media_placement_augmentation=True)
    return _jax_init(OtterVLM(cfg, dtype=jnp.float32), seed)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Inputs written once; one world-2 and one world-4 launch."""
    d = str(tmp_path_factory.mktemp("parallel"))
    cfg, _, _, flat = jax_tiny_train()
    write_model(d, "mpt", flat, cfg)
    np.savez(os.path.join(d, "train_batch.npz"),
             **train_batch(cfg, 1, batch=4, seq=24))
    with open(os.path.join(d, "train.json"), "w") as f:
        json.dump({"lr": LR}, f)
    rng = np.random.default_rng(5)
    np.savez(os.path.join(d, "opt8_grads.npz"), **{
        k: (rng.standard_normal(v.shape) * 1e-5).astype(np.float32)
        for k, v in flat.items()})
    lcfg, _, _, lflat = jax_vlm("llama")
    write_model(d, "llama", lflat, lcfg)
    for arch in ("mpt", "llama"):
        np.savez(os.path.join(d, f"{arch}_gen.npz"), **_gen_inputs(arch))
    sft_argv, pre_argv = _mains_spec(d)
    with open(os.path.join(d, "mains.json"), "w") as f:
        json.dump({"sft": sft_argv, "pretrain": pre_argv}, f)
    np.savez(os.path.join(d, "sft_params.npz"),
             **_jax_sft_init(tuple(sft_argv)))
    np.savez(os.path.join(d, "pre_params.npz"), **_jax_pretrain_init())
    launch(2, ["train", "opt8", "tp_generate", "mains"], d)
    launch(4, ["train", "tp_generate"], d)
    return d


def _npz(d, name):
    with np.load(os.path.join(d, name)) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's unsharded step over the same global batch: metrics and the
    trainable params."""
    cfg, model, params, _ = jax_tiny_train()
    batch = {k: jnp.asarray(v)
             for k, v in train_batch(cfg, 1, batch=4, seq=24).items()}
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(trainable, lr=LR, total_steps=10)
    state = jstep.TrainState.create(params, cfg, tx)
    state, m = jax.jit(jstep.make_train_step(model, cfg, tx))(state, batch)
    return {k: float(v) for k, v in m.items()}, _flat(state.trainable)


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_sharded_train_step_matches_jax(launches, mesh):
    """dp2 / fsdp2 / sp2 / tp2 and two composed world-4 meshes: loss, grad
    norm and every updated trainable parameter."""
    ref, ref_params = _jax_step()
    got = _npz(launches, f"train_{mesh}.npz")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-4)
    assert float(got["tokens"]) == ref["tokens"]
    for k, v in ref_params.items():
        np.testing.assert_allclose(got[f"param/{k}"], v, atol=3e-4,
                                   rtol=3e-3, err_msg=f"{mesh} {k}")


def _jax_adam8_state(grads):
    """JAX's 8-bit chain (`make_optimizer(state_bits=8)`) over the tiny
    model's trainable tree after the worker's two updates with `grads`:
    its flat {mu_q, mu_s, nu_q, nu_s}."""
    cfg, _, params, _ = jax_tiny_train()
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(trainable, lr=1e-3, total_steps=10,
                              state_bits=8)
    state = tx.init(trainable)
    g = traverse_util.unflatten_dict(
        {k: jnp.asarray(grads[k]) for k in _flat(trainable)}, sep="/")
    for _ in range(2):
        updates, state = tx.update(g, state, trainable)
        trainable = jax.tree_util.tree_map(lambda a, b: a + b, trainable,
                                           updates)
    from test_torch_opt8 import _adam8_state
    js = _adam8_state(state)
    return {name: _flat(getattr(js, name))
            for name in ("mu_q", "mu_s", "nu_q", "nu_s")}


def test_adam8_moments_at_fsdp2_equal_one_devices(launches):
    """Two 8-bit Adam updates over the same gradients: the gathered int8
    moments, their scales and the parameters equal one device's exactly
    (the 512-blocks follow the global flat layout across the shards), and
    the moments are within 1 LSB of JAX's chain and the scales within
    1e-5 relative (`tests/test_torch_opt8.py`'s bars). The gradients'
    global norm stays under the clip, so the norm's order of sums (per
    shard, then across ranks) does not enter the update."""
    got = _npz(launches, "opt8.npz")
    keys = sorted({k.rsplit("/", 1)[0] for k in got})
    assert any(k.startswith("mu/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[f"{k}/sharded"], got[f"{k}/one"],
                                      err_msg=k)
    ref = _jax_adam8_state(_npz(launches, "opt8_grads.npz"))
    for key, jkey in (("mu", "mu_q"), ("nu", "nu_q")):
        for k, want in ref[jkey].items():
            assert got[f"{key}/{k}/sharded"].shape == want.shape, k
            lsb = np.abs(got[f"{key}/{k}/sharded"].astype(np.int32)
                         - want.astype(np.int32))
            assert lsb.max() <= 1, (key, k, int(lsb.max()))
    for key in ("mu_s", "nu_s"):
        for k, want in ref[key].items():
            np.testing.assert_allclose(got[f"{key}/{k}/sharded"], want,
                                       rtol=1e-5, atol=0, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    """The JAX engine's greedy tokens over the same weights and prompts
    (f32 cache)."""
    from otter_tpu.config import GenerationConfig as JGen
    from otter_tpu.generation import engine as jengine
    cfg, model, params, _ = jax_vlm(arch)
    b = _gen_inputs(arch)
    return np.asarray(jengine.OtterGenerator(
        model, {"params": params}, cfg, cache_dtype=jnp.float32).generate(
            jnp.asarray(b["vision_x"]), jnp.asarray(b["input_ids"]),
            gen=JGen(max_new_tokens=4, do_sample=False)))


@pytest.mark.parametrize("world,arch", [(2, "mpt"), (2, "llama"),
                                        (4, "mpt"), (4, "llama")])
def test_tensor_parallel_generation_equals_the_whole_models(launches, world,
                                                            arch):
    """Greedy tokens with parameters sharded at tp2 (world 2) and fsdp2 x
    tp2 (world 4) equal the JAX engine's over the same weights and the
    port's unsharded engine's, exactly; the self-attention keeps its
    rank's heads (and so does the KV cache it writes)."""
    got = _npz(launches, f"tp_generate_{world}.npz")
    np.testing.assert_array_equal(got[f"{arch}/tp"], _jax_tokens(arch))
    np.testing.assert_array_equal(got[f"{arch}/tp"], got[f"{arch}/ref"])
    cfg = jax_vlm(arch)[0].text
    tp = 2
    assert tuple(got[f"{arch}/local_heads"]) == (
        cfg.num_attention_heads // tp, cfg.kv_heads // tp)


def _logged(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _losses(run_dir):
    return [r["loss"] for r in _logged(os.path.join(run_dir,
                                                    "metrics.jsonl"))]


def _jax_sft_losses(argv, epochs):
    """The JAX SFT chain over `argv`'s YAML as its `main` runs it, but
    with each epoch from a fresh `build_loaders` (a resumed run's: the
    task-group draw starts again from the seed): its loader, its
    `prepare_batch` and its jitted `make_train_step` from `main`'s
    initial weights, one process. One loss a step."""
    from otter_tpu.train import sft as jsft
    from otter_tpu.train import step as jstep
    from transformers import AutoTokenizer
    args = _jax_sft_args(argv)
    model, cfg = jsft.build_model_and_config(args)
    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    tok.add_special_tokens({"additional_special_tokens": [
        "<|endofchunk|>", "<image>", "<answer>"]})
    if tok.pad_token is None:
        tok.add_special_tokens({"pad_token": "<PAD>"})
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in _jax_sft_init(tuple(argv)).items()},
        sep="/")
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(
        trainable, lr=args.learning_rate, schedule=args.lr_scheduler,
        warmup_steps=args.warmup_steps, total_steps=100,
        weight_decay=args.weight_decay)
    state = jstep.TrainState.create(params, cfg, tx)
    step = jax.jit(jstep.make_train_step(
        model, cfg, tx, mask_embedding=args.mask_lm_head,
        attend_previous=not cfg.use_media_placement_augmentation,
        fused_ce_chunk=args.fused_ce_chunk))
    out = []
    for epoch in range(epochs):
        multi = jsft.build_loaders(args, cfg, tok, 0, 1)
        multi.set_epoch(epoch)
        for b in multi:
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    jsft.prepare_batch(b, tok, args).items()})
            out.append(float(m["loss"]))
    return out


def test_sft_main_across_two_processes_matches_one(launches, monkeypatch):
    """`sft.main` with --multi_host --fsdp 2 over the YAML, from the JAX
    trainer's initial weights, then resumed for a second epoch, then at
    one device from the mesh run's rank-0 checkpoint for a third: every
    step's loss equals the JAX chain's over the same batches within 1e-4
    relative (the learning rate is constant)."""
    from otter_tpu import native as jnative
    from otter_tpu_torch import native as tnative
    from otter_tpu_torch.train import sft
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    spec = json.load(open(os.path.join(launches, "mains.json")))
    assert "--lr_scheduler" not in spec["sft"]        # constant
    want = _jax_sft_losses(spec["sft"], epochs=3)
    run = os.path.join(launches, "sft_mesh")
    got = _losses(run)
    assert len(got) == 2 * len(want) // 3 and len(got) >= 4
    np.testing.assert_allclose(got, want[:len(got)], rtol=1e-4)
    resumed = sft.main(sft.parse_args(
        spec["sft"] + ["--run_name", "sft_mesh", "--num_epochs", "3",
                       "--resume_from_checkpoint", "latest"]), device="cpu")
    assert resumed.step == len(want)
    np.testing.assert_allclose(_losses(run), want, rtol=1e-4)


def _jax_pretrain_metrics(argv):
    """The JAX pretrainer's loop as its `train` runs it at one process,
    over the shards of `argv` (its `get_data`, labels, placement draws and
    jitted `make_pretrain_step`, from its initial weights), without its
    mesh and its checkpoint: each step's metrics."""
    import random

    from otter_tpu import config as jcfg
    from otter_tpu.data import webdataset as jwds
    from otter_tpu.models.otter import OtterVLM
    from otter_tpu.train import pretrain as jpre
    from otter_tpu.train import step as jstep
    from transformers import AutoTokenizer
    args = jpre.PretrainArgs()
    for flag, val in zip(argv[::2], argv[1::2]):
        name = flag[2:]
        setattr(args, name, type(getattr(args, name))(val))
    cfg = jcfg.OtterConfig.tiny("mpt").replace(
        use_media_placement_augmentation=True)
    args.media_token_id = cfg.media_token_id
    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    tok.add_special_tokens({"additional_special_tokens": [
        "<|endofchunk|>", "<image>"]})
    if tok.pad_token is None:
        tok.add_special_tokens({"pad_token": "<PAD>"})
    datas = {t: jwds.get_data(args, tok, t) for t in ("laion", "mmc4")}
    steps = min(d.num_batches for d in datas.values())
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in _jax_pretrain_init().items()},
        sep="/")
    model = OtterVLM(cfg, dtype=jnp.float32)
    trainable, _ = jstep.split_params(params, cfg)
    tx = jstep.make_optimizer(
        trainable, lr=args.learning_rate, schedule=args.lr_scheduler,
        warmup_steps=args.warmup_steps, total_steps=steps,
        weight_decay=args.weight_decay)
    state = jstep.TrainState.create(params, cfg, tx)
    step_fn = jax.jit(jpre.make_pretrain_step(
        model, cfg, tx, loss_multiplier_laion=args.loss_multiplier_laion,
        loss_multiplier_mmc4=args.loss_multiplier_mmc4),
        static_argnames=("attend_prev",))
    pyrng = random.Random(args.seed)
    pad_id = tok.pad_token_id or 0
    for d in datas.values():
        d.dataloader.set_epoch(0)
        # one reader thread reads the shards in order, as the port's
        # `--workers 1` run does; two threads interleave them as they run
        d.dataloader.num_parallel_shards = 1
    iters = {t: iter(d.dataloader) for t, d in datas.items()}
    out = []
    for _ in range(steps):
        batches = {}
        for t, it in iters.items():
            raw = next(it)
            labels = (jpre.interleaved_labels(
                raw["input_ids"], pad_id, cfg.media_token_id,
                cfg.eoc_token_id) if t == "mmc4" else jpre.pair_labels(
                raw["input_ids"], pad_id, cfg.media_token_id))
            batches[t] = {"vision_x": jnp.asarray(raw["images"]),
                          "input_ids": jnp.asarray(raw["input_ids"]),
                          "attention_mask": jnp.asarray(
                              raw["attention_mask"]),
                          "labels": jnp.asarray(labels)}
        state, m = step_fn(state, batches["laion"], batches["mmc4"],
                           attend_prev=pyrng.random() < 0.5)
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_pretrain_main_across_two_processes_matches_one(launches,
                                                        monkeypatch):
    """`pretrain.main` with --multi_host --tp 2 over the shards, from the
    JAX pretrainer's initial weights: each step's three losses equal the
    JAX loop's over the same shards (its readers at the port's image
    size), within 1e-4 relative."""
    from otter_tpu import native as jnative
    from otter_tpu.data import webdataset as jwds
    monkeypatch.setattr(jnative, "available", lambda: False)
    # the JAX readers take 224 pixels whatever --patch_image_size says
    # (a divergence the port does not copy): the tiny model's 28 here
    for name in ("make_pair_preprocessor", "make_interleaved_preprocessor"):
        monkeypatch.setattr(jwds, name, functools.partial(
            getattr(jwds, name), patch_size=28))
    spec = json.load(open(os.path.join(launches, "mains.json")))
    got = _logged(os.path.join(launches, "pre_mesh", "metrics.jsonl"))
    ref = _jax_pretrain_metrics(spec["pretrain"])
    assert [r["step"] for r in got] == list(range(1, len(ref) + 1)) \
        and len(ref) >= 3
    for a, b in zip(got, ref):
        for key in ("loss", "loss_laion", "loss_mmc4"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4)
