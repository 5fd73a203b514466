"""The port's data and checkpoint tools (`otter_tpu_torch.tools`) against
the JAX package's: checkpoint surgery on the same trees, the shard
writers round-tripped through the port's `ShardPipeline`, convert-it's
image packs read back by the port's `ImageStore`, and Syphus with a fake
chat function (nothing is posted)."""

import base64
import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from helpers import TinyTokenizer
from otter_tpu import config as jcfg
from otter_tpu.models.convert import flax_to_hf
from otter_tpu.models.otter import OtterVLM as JaxOtterVLM
from otter_tpu.tools import shards as jshards
from otter_tpu.tools import surgery as jsurgery
from otter_tpu.tools import syphus as jsyphus
from otter_tpu.tools import syphus_datasets as jsyphus_ds
from otter_tpu_torch.data.webdataset import (ShardPipeline,
                                             make_interleaved_preprocessor,
                                             make_pair_preprocessor,
                                             tar_samples)
from otter_tpu_torch.models.convert import (export_flax_params,
                                            load_flax_params)
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.tools import convert_it, shards, surgery, syphus
from otter_tpu_torch.tools import syphus_datasets
from torch_parity_helpers import port_cfg


def _png(rng, n=32):
    buf = io.BytesIO()
    Image.fromarray((rng.random((n, n, 3)) * 255).astype(np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


# ── surgery ─────────────────────────────────────────────────────────

def test_inject_lm_into_flamingo_matches_jax():
    """A bare MPT checkpoint (names without the decoder_layer wrapping)
    merged with the Flamingo weights gives JAX's tree, and the port's
    model loads it."""
    cfg = jcfg.OtterConfig.tiny("mpt")
    params = jax.jit(JaxOtterVLM(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, 3, 28, 28), jnp.float32),
        jnp.zeros((1, 8), jnp.int32))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        params, sep="/").items()}
    lm_state, flamingo_state = {}, {}
    for k, v in flax_to_hf(flat, cfg).items():
        if ".decoder_layer." in k or k in (
                "lang_encoder.transformer.wte.weight",
                "lang_encoder.transformer.norm_f.weight"):
            lm_state[k.replace("lang_encoder.", "", 1).replace(
                ".decoder_layer.", ".")] = v
        else:
            flamingo_state[k] = v
    ref = jsurgery.inject_lm_into_flamingo(lm_state, flamingo_state, cfg)
    ours = surgery.inject_lm_into_flamingo(lm_state, flamingo_state, cfg)
    assert set(ours) == set(ref) == set(flat)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    model = OtterVLM(port_cfg(cfg), dtype=torch.float32, device="cpu")
    load_flax_params(model, ours)
    loaded = export_flax_params(model)
    for k in ref:
        np.testing.assert_array_equal(loaded[k], ref[k], err_msg=k)


@pytest.mark.parametrize("subtract", [False, True])
def test_apply_delta_matches_jax(subtract):
    rng = np.random.default_rng(0)
    base = {"a": rng.standard_normal(3), "b": rng.standard_normal((2, 2)),
            "only_base": np.ones(2)}
    delta = {"a": rng.standard_normal(3), "b": rng.standard_normal((2, 2)),
             "only_delta": np.zeros(1)}
    ref = jsurgery.apply_delta(base, delta, subtract=subtract)
    ours = surgery.apply_delta(
        {k: torch.from_numpy(v) for k, v in base.items()}, delta,
        subtract=subtract)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k]), ref[k], rtol=0,
                                   atol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match="shape mismatch"):
        surgery.apply_delta({"a": np.ones(2)}, {"a": np.ones(3)})


def test_merge_lora_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"layers_0": {"attn": {"Wqkv": {
        "base": {"kernel": rng.standard_normal((8, 24)).astype(np.float32),
                 "bias": rng.standard_normal(24).astype(np.float32)},
        "lora_a": rng.standard_normal((8, 4)).astype(np.float32),
        "lora_b": rng.standard_normal((4, 24)).astype(np.float32)}}},
        "norm_f": {"scale": np.ones(8, np.float32)}}
    ref = traverse_util.flatten_dict(jsurgery.merge_lora(tree), sep="/")
    flat = traverse_util.flatten_dict(tree, sep="/")
    ours = surgery.merge_lora({k: torch.from_numpy(v)
                               for k, v in flat.items()})
    assert set(ours) == set(ref) and not any("lora" in k for k in ours)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # a bf16 kernel stays bf16, folded in f32
    key = "layers_0/attn/Wqkv/base/kernel"
    merged = surgery.merge_lora(
        dict(flat, **{key: torch.from_numpy(flat[key]).bfloat16()}))
    assert merged[key].dtype == torch.bfloat16


# ── shards ──────────────────────────────────────────────────────────

def test_shard_writer_rollover_reads_back(tmp_path, rng):
    out = tmp_path / "wds"
    with shards.ShardWriter(str(out), maxcount=2) as w:
        for i in range(5):
            w.write({"__key__": f"k{i}", "txt": f"c{i}", "png": _png(rng)})
    assert len(w.shards_written) == 3
    samples = [s for p in w.shards_written for s in tar_samples(p)]
    assert [s["__key__"] for s in samples] == [f"k{i}" for i in range(5)]
    assert set(samples[0]) == {"__key__", "txt", "png"}


def _mmc4_layout(tmp_path, rng):
    img_tar = tmp_path / "shard_0_images_v2.tar"
    with tarfile.open(img_tar, "w") as tf:
        for name in ("a.jpg", "b.jpg"):
            data = _png(rng, 512)
            info = tarfile.TarInfo(f"shard_0/{name}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    doc = {"text_list": ["intro", "about a", "about b"],
           "image_info": [
               {"image_name": "a.jpg", "matched_sim": 0.5,
                "matched_text_index": 1},
               {"image_name": "b.jpg", "matched_sim": 0.6,
                "matched_text_index": 2}]}
    docs = tmp_path / "docs_shard_0_v2.jsonl"
    docs.write_text(json.dumps(doc) + "\n")
    return str(img_tar), str(docs)


def test_convert_mmc4_round_trips_through_the_pipeline(tmp_path, rng):
    img_tar, docs = _mmc4_layout(tmp_path, rng)
    n = shards.convert_mmc4_to_wds([img_tar], [docs], str(tmp_path / "wds"))
    assert n == 1
    jshards.convert_mmc4_to_wds([img_tar], [docs], str(tmp_path / "jwds"))
    ours, = os.listdir(tmp_path / "wds")

    def samples(d):   # (a sample's key is a fresh uuid)
        return [{k: v for k, v in s.items() if k != "__key__"}
                for s in tar_samples(str(tmp_path / d / ours))]

    assert samples("wds") == samples("jwds")
    fn = make_interleaved_preprocessor(
        TinyTokenizer(), media_token_id=253, patch_size=16,
        sim_threshold=0.24, single_image_drop=0.0, native=False)
    pipe = ShardPipeline([str(tmp_path / "wds" / ours)], fn, 1,
                         shuffle_buffer=0, num_parallel_shards=1)
    b = next(iter(pipe))
    assert b["images"].shape == (1, 5, 1, 3, 16, 16)
    assert int((b["input_ids"] == 253).sum()) == 2


def test_convert_laion_tsv_round_trips_through_the_pipeline(tmp_path, rng):
    root = tmp_path / "tsv"
    root.mkdir()
    with open(root / "part-image-0.tsv", "w") as fi, \
            open(root / "part-text-0.tsv", "w") as ft:
        for i in range(4):
            b64 = base64.b64encode(_png(rng)).decode()
            cap = json.dumps({"captions": [f"caption {i}"
                                           if i != 2 else None]})
            fi.write(f"img{i}\t{b64}\n")
            ft.write(f"img{i}\t{cap}\n")
    n = shards.convert_laion_tsv_to_wds(str(root), str(tmp_path / "wds"),
                                        num_threads=1)
    assert n == 3   # the None caption row is dropped
    shard = os.path.join(tmp_path / "wds",
                         sorted(os.listdir(tmp_path / "wds"))[0])
    pipe = ShardPipeline([shard], make_pair_preprocessor(
        TinyTokenizer(), patch_size=16, native=False), batch_size=3,
        shuffle_buffer=0, num_parallel_shards=1)
    b = next(iter(pipe))
    assert b["images"].shape == (3, 1, 1, 3, 16, 16)


@pytest.mark.parametrize("remove", [False, True])
def test_make_a_train_matches_jax(tmp_path, remove):
    data = {"data": {"A": {"rel_ins_ids": ["B", "ghost"]},
                     "B": {"rel_ins_ids": []},
                     "C": {"rel_ins_ids": ["A"]}}}
    src = tmp_path / "ins.json"
    src.write_text(json.dumps(data))
    ours = shards.make_a_train(str(src), str(tmp_path / "a.json"),
                               remove_rel_ins_ids=remove)
    ref = jshards.make_a_train(str(src), str(tmp_path / "b.json"),
                               remove_rel_ins_ids=remove)
    assert ours == ref
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()


# ── convert-it and Syphus ───────────────────────────────────────────

def test_convert_it_packs_load_in_the_image_store(tmp_path, rng):
    from otter_tpu_torch.data.mimicit import ImageStore, decode_base64_image
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(3):
        Image.fromarray((rng.random((16, 16, 3)) * 255).astype(
            np.uint8)).save(folder / f"img{i}.png")
    images = convert_it.pack_image_folder(str(folder), prefix="T",
                                          resize_res=8)
    assert sorted(images) == ["T_img0", "T_img1", "T_img2"]
    path = convert_it.convert_json_to_parquet(
        convert_it.save_json(images, str(tmp_path / "imgs.json")),
        str(tmp_path / "imgs.parquet"))
    store = ImageStore()
    store.load(path)
    assert decode_base64_image(store.get("T_img0")).size == (8, 8)


def _chat(messages):
    assert messages[0]["role"] == "system"
    return ("instruction: What is shown?\nanswer: A cat.\n"
            "Question: and its colour?\nAnswer: grey")


def test_syphus_generates_with_an_injected_chat_function(tmp_path):
    prompt = {"system_message": "You generate QA pairs.",
              "in_context": [
                  {"role": "user", "content": "a dog in a park"},
                  {"role": "assistant", "content": [
                      {"instruction": "What animal?", "answer": "A dog"}]}]}
    ppath = tmp_path / "prompt.json"
    ppath.write_text(json.dumps(prompt))
    qpath = tmp_path / "annotations.json"
    qpath.write_text(json.dumps({"V1": "a cat on a sofa",
                                 "V2": {"objects": ["cat"]}}))
    ours = syphus.generate_instructions(
        syphus.JsonAnnotationsDataset("DC", str(ppath), str(qpath)), _chat,
        num_threads=2, output_path=str(tmp_path / "out.json"))
    ref = jsyphus.generate_instructions(
        jsyphus.JsonAnnotationsDataset("DC", str(ppath), str(qpath)), _chat,
        num_threads=1)
    assert ours == ref and len(ours["data"]) == 4
    assert json.loads((tmp_path / "out.json").read_text()) == ours


def test_syphus_dataset_adapters_and_prompts_match_jax(tmp_path):
    assert sorted(syphus_datasets.DATASET_REGISTRY) == \
        sorted(jsyphus_ds.DATASET_REGISTRY) == sorted(syphus.AVAILABLE_DATASETS)
    p = tmp_path / "sd.json"
    p.write_text(json.dumps([{"img_id": "42", "sentences": ["a", "b"]}]))
    ours = syphus_datasets.SpotTheDifference(str(p))
    ref = jsyphus_ds.SpotTheDifference(str(p))
    assert ours.query_inputs == ref.query_inputs == [
        {"id": "42", "sentences": "a\nb"}]
    assert ours.prompt == ref.prompt and ours.prompt["in_context"]


def test_syphus_main_posts_through_the_chat_function(tmp_path, monkeypatch):
    """`main` builds its provider's chat function through `make_chat_fn`;
    a fake provider stands in for the HTTP one."""
    p = tmp_path / "sd.json"
    p.write_text(json.dumps([{"img_id": "42", "sentences": ["a", "b"]}]))
    monkeypatch.setattr(syphus, "openai_chat_fn", lambda **kw: _chat)
    result = syphus.main(["--name", "change.SpotTheDifference",
                          "--query_inputs", str(p), "--output",
                          str(tmp_path / "o.json"), "--num_threads", "1"])
    assert len(result["data"]) == 2 and not result["errors"]
