"""Port parity: the MIMIC-IT data chain of `otter_tpu_torch.data` against
the JAX package's `otter_tpu.data`, on a synthetic on-disk dataset made in
the test (every task group, three image-pack layouts, in-context
samples, video, task descriptions).

The JAX dataset runs with its native C++ decoder switched off
(`otter_tpu.native.available` patched to False): its scaled decode differs
from PIL's bicubic, and the port decodes through PIL only. Token ids,
masks and texts are then equal, float pixels within 1e-6 (both are PIL's
resize and the same numpy normalisation) and the uint8 arrays of
`device_preprocess` equal. `TinyTokenizer` ids come from `hash`, so they
are equal within one process, which is where both sides run.
"""

import base64
import io
import json
import random
import threading
import time

import numpy as np
import pytest
import yaml

from helpers import TinyTokenizer
from otter_tpu import data as jdata
from otter_tpu import native as jnative
from otter_tpu.data import loader as jloader
from otter_tpu.data import mimicit as jmimicit
from otter_tpu.data import transforms as jtransforms
from otter_tpu.data import yaml_spec as jyaml
from otter_tpu_torch import data as tdata
from otter_tpu_torch.data import loader as tloader
from otter_tpu_torch.data import mimicit as tmimicit
from otter_tpu_torch.data import transforms as ttransforms
from otter_tpu_torch.data import yaml_spec as tyaml

GROUPS = ("IMAGE_TEXT", "VIDEO_TEXT", "IMAGE_TEXT_IN_CONTEXT", "TEXT_ONLY")


def _png_b64(rng, h, w):
    from PIL import Image
    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Paths of one task a group, over three image packs: a JSON of {id:
    b64}, a JSON of {id: {"base64": b64, ...}} and a parquet of a pandas
    frame indexed by id."""
    import pandas as pd
    tmp = tmp_path_factory.mktemp("mimicit")
    rng = np.random.default_rng(5)
    ids = [f"IMG_{i}" for i in range(24)]
    b64 = {i: _png_b64(rng, int(rng.integers(20, 41)),
                       int(rng.integers(20, 41))) for i in ids}
    (tmp / "plain.json").write_text(json.dumps({i: b64[i]
                                                for i in ids[:8]}))
    (tmp / "nested.json").write_text(json.dumps(
        {i: {"base64": b64[i], "source": "test"} for i in ids[8:16]}))
    pd.DataFrame({"base64": [b64[i] for i in ids[16:]]},
                 index=pd.Index(ids[16:], name="id")).to_parquet(
        tmp / "pack.parquet")
    words = [f"word{i}" for i in range(50)]

    def text(n):
        return " ".join(rng.choice(words, n))

    groups = {
        "IMAGE_TEXT": {f"IT_{i}": {"instruction": text(5 + i),
                                   "answer": text(3 + i),
                                   "image_ids": [ids[i]],
                                   "rel_ins_ids": [f"IT_{(i + 1) % 8}"]}
                       for i in range(8)},
        "VIDEO_TEXT": {f"VT_{i}": {"instruction": text(4), "answer": text(6),
                                   "image_ids": ids[16 + i:22 + i]}
                       for i in range(3)},
        "IMAGE_TEXT_IN_CONTEXT": {
            f"IC_{i}": {"instruction": f"  {text(4)}? ", "answer": text(5),
                        "image_ids": ids[8 + 2 * (i % 3):12 + 2 * (i % 3)]}
            for i in range(6)},
        "TEXT_ONLY": {f"TO_{i}": {"instruction": text(6), "answer": text(2)}
                      for i in range(4)},
    }
    spec = {}
    for group, data in groups.items():
        path = tmp / f"{group}.json"
        path.write_text(json.dumps({"data": data}))
        cfg = {"mimicit_path": str(path), "num_samples": 0,
               "images_path": str(tmp / "plain.json")}
        if group == "IMAGE_TEXT_IN_CONTEXT":
            tc = tmp / "ic_train.json"
            tc.write_text(json.dumps({k: [f"IC_{(j + 1) % 6}",
                                          f"IC_{(j + 2) % 6}",
                                          f"IC_{(j + 3) % 6}"]
                                      for j, k in enumerate(data)}))
            cfg["train_config_path"] = str(tc)
            cfg["images_path"] = str(tmp / "nested.json")
        if group == "VIDEO_TEXT":
            cfg["images_path"] = str(tmp / "pack.parquet")
            cfg["num_samples"] = 5              # replicated to 5
        if group == "IMAGE_TEXT":
            cfg["task_description"] = ["Describe.", "Answer briefly."]
        spec[group] = {f"{group}_task": cfg}
    (tmp / "data.yaml").write_text(yaml.safe_dump(spec))
    return tmp, spec


def _tasks(mod, spec, group):
    return mod.tasks_from_spec(spec)[group]


def _pair(spec, group, monkeypatch, **kw):
    monkeypatch.setattr(jnative, "available", lambda: False)
    tok = TinyTokenizer()
    kw = dict(dict(task_group=group, patch_image_size=16,
                   resample_frames_to=4, max_seq_len=40, seed=3), **kw)
    return (tdata.MimicitDataset(_tasks(tyaml, spec, group), tok, **kw),
            jdata.MimicitDataset(_tasks(jyaml, spec, group), tok, **kw))


def _assert_sample_equal(a, r, image_atol=1e-6):
    assert a["id"] == r["id"] and a["full_text"] == r["full_text"]
    assert a["task_group"] == r["task_group"]
    np.testing.assert_array_equal(a["input_ids"], r["input_ids"])
    np.testing.assert_array_equal(a["attention_mask"], r["attention_mask"])
    assert a["input_ids"].dtype == r["input_ids"].dtype
    assert a["patch_images"].dtype == r["patch_images"].dtype
    assert a["patch_images"].shape == r["patch_images"].shape
    if a["patch_images"].dtype == np.uint8:
        np.testing.assert_array_equal(a["patch_images"], r["patch_images"])
    else:
        np.testing.assert_allclose(a["patch_images"], r["patch_images"],
                                   atol=image_atol, rtol=0)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("device_preprocess", [False, True])
def test_dataset_items_equal_jax(dataset_dir, group, device_preprocess,
                                 monkeypatch):
    _, spec = dataset_dir
    port, ref = _pair(spec, group, monkeypatch,
                      device_preprocess=device_preprocess,
                      with_task_description=True,
                      populate_rel_ins=group == "IMAGE_TEXT")
    assert len(port) == len(ref) > 0
    assert port.train_data_list == ref.train_data_list
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(port)):
            _assert_sample_equal(port[i], ref[i])
    shapes = {"IMAGE_TEXT": (1, 1), "VIDEO_TEXT": (1, 4),
              "IMAGE_TEXT_IN_CONTEXT": (4, 1), "TEXT_ONLY": (1, 1)}
    assert port[0]["patch_images"].shape[:2] == shapes[group]


def test_task_descriptions_follow_the_seeded_sample_rng(dataset_dir,
                                                        monkeypatch):
    """The description a sample draws comes from random.Random((seed,
    epoch, index).__hash__()): both lists of the two epochs are JAX's, and
    they are not one choice throughout."""
    _, spec = dataset_dir
    drawn = []
    for seed in (0, 1, 2):
        port, ref = _pair(spec, "IMAGE_TEXT", monkeypatch, seed=seed,
                          with_task_description=True)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [port[i]["full_text"].split("\n")[0]
                   for i in range(len(port))]
            assert got == [ref[i]["full_text"].split("\n")[0]
                           for i in range(len(ref))]
            drawn += got
    assert set(drawn) == {"Describe.", "Answer briefly."}


@pytest.mark.parametrize("pad", [1, 8, 64])
def test_collate_equal_jax(dataset_dir, pad, monkeypatch):
    _, spec = dataset_dir
    port, ref = _pair(spec, "IMAGE_TEXT_IN_CONTEXT", monkeypatch)
    vport, vref = _pair(spec, "VIDEO_TEXT", monkeypatch)
    for (p, r), idx in (((port, ref), [0, 3, 5]), ((vport, vref), [1, 2])):
        a = p.collate([p[i] for i in idx], pad_to_multiple=pad)
        b = r.collate([r[i] for i in idx], pad_to_multiple=pad)
        assert a["id"] == b["id"] and a["full_text"] == b["full_text"]
        assert a["task_group"] == b["task_group"]
        for k, v in b["net_input"].items():
            assert a["net_input"][k].dtype == v.dtype, k
            np.testing.assert_allclose(a["net_input"][k], v, atol=1e-6,
                                       rtol=0, err_msg=k)
        assert a["net_input"]["input_ids"].shape[1] % pad == 0


def test_image_store_layouts_equal_jax(dataset_dir):
    tmp, _ = dataset_dir
    port, ref = tmimicit.ImageStore(), jmimicit.ImageStore()
    for name in ("plain.json", "nested.json", "pack.parquet"):
        port.load(str(tmp / name))
        ref.load(str(tmp / name))
    for i in range(24):
        assert port.get(f"IMG_{i}") == ref.get(f"IMG_{i}")
    with pytest.raises(KeyError):
        port.get("IMG_99")
    with pytest.raises(ValueError, match="unsupported"):
        port.load(str(tmp / "data.yaml"))


def test_parquet_without_pyarrow_says_so(dataset_dir, monkeypatch):
    import sys
    tmp, _ = dataset_dir
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        tmimicit.ImageStore().load(str(tmp / "pack.parquet"))


@pytest.mark.parametrize("n,frames", [(7, 4), (3, 5), (32, 32), (40, 9)])
def test_resampling_equal_jax(n, frames):
    ids = [f"f{i}" for i in range(n)]
    assert tmimicit.resample_frames(ids, frames) == \
        jmimicit.resample_frames(ids, frames)
    for num in (0, 2, n, 3 * n + 1):
        assert tmimicit.resample_data(ids, num) == \
            jmimicit.resample_data(ids, num)


def _bad_specs(tmp):
    nodata = tmp / "nodata.json"
    nodata.write_text(json.dumps({"other": {}}))
    broken = tmp / "broken.json"
    broken.write_text("{not json")
    good = str(tmp / "IMAGE_TEXT.json")
    return [
        {},
        [],
        {"BOGUS": {}},
        {"IMAGE_TEXT": ["not", "a", "mapping"]},
        {"IMAGE_TEXT": {"t": "not a mapping"}},
        {"IMAGE_TEXT": {"t": {}}},
        {"IMAGE_TEXT": {"t": {"mimicit_path": "/nonexistent.json"}}},
        {"IMAGE_TEXT": {"t": {"mimicit_path": str(nodata)}}},
        {"IMAGE_TEXT": {"t": {"mimicit_path": str(broken)}}},
        {"IMAGE_TEXT": {"t": {"mimicit_path": good, "num_samples": "9"}}},
        {"IMAGE_TEXT": {"t": {"mimicit_path": good,
                              "images_path": "/none.parquet",
                              "train_config_path": "/none.json"}}},
        {"TEXT_ONLY": {"a": {"mimicit_path": good},
                       "b": {"mimicit_path": good, "num_samples": 1.5}},
         "VIDEO_TEXT": {"c": {}}},
    ]


def test_validate_spec_refuses_alike(dataset_dir, tmp_path):
    tmp, spec = dataset_dir
    assert tyaml.validate_spec(spec) == jyaml.validate_spec(spec) == []
    for bad in _bad_specs(tmp):
        got = tyaml.validate_spec(bad)
        assert got and got == jyaml.validate_spec(bad), bad
        assert tyaml.validate_spec(bad, check_paths=False,
                                   check_data_key=False) == \
            jyaml.validate_spec(bad, check_paths=False,
                                check_data_key=False)


def test_verify_yaml_refuses_alike(dataset_dir, tmp_path):
    tmp, spec = dataset_dir
    tyaml.verify_yaml(str(tmp / "data.yaml"))
    assert tyaml.load_yaml(str(tmp / "data.yaml")) == spec
    for i, bad in enumerate(_bad_specs(tmp)):
        path = tmp_path / f"bad{i}.yaml"
        path.write_text(yaml.safe_dump(bad))
        with pytest.raises(tdata.DataSpecError) as port:
            tdata.verify_yaml(str(path))
        with pytest.raises(jdata.DataSpecError) as ref:
            jdata.verify_yaml(str(path))
        assert str(port.value) == str(ref.value)


def test_tasks_from_spec_equal_jax(dataset_dir):
    _, spec = dataset_dir
    port, ref = tyaml.tasks_from_spec(spec), jyaml.tasks_from_spec(spec)
    assert {g: [vars(t) for t in ts] for g, ts in port.items()} == \
        {g: [vars(t) for t in ts] for g, ts in ref.items()}


def _loaders(mod_data, spec, rank, world, batch=2):
    tok = TinyTokenizer()
    loaders = []
    for group in ("IMAGE_TEXT", "IMAGE_TEXT_IN_CONTEXT", "VIDEO_TEXT"):
        ds = mod_data.MimicitDataset(
            mod_data.tasks_from_spec(spec)[group], tok, task_group=group,
            patch_image_size=16, resample_frames_to=4, max_seq_len=40,
            seed=7)
        loaders.append(mod_data.MimicitLoader(
            ds, batch, seed=7, num_workers=2, rank=rank, world_size=world))
    return mod_data.WeightedMultiLoader(loaders, seed=7)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_loader_batches_equal_jax_over_two_epochs(dataset_dir, rank, world,
                                                  monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    _, spec = dataset_dir
    port, ref = (_loaders(tdata, spec, rank, world),
                 _loaders(jdata, spec, rank, world))
    assert len(port) == len(ref) > 0
    seen = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert [b["id"] for b in got] == [b["id"] for b in want]
        for a, b in zip(got, want):
            for k, v in b["net_input"].items():
                np.testing.assert_allclose(a["net_input"][k], v, atol=1e-6,
                                           rtol=0)
            assert a["net_input"]["input_ids"].shape[1] % 64 == 0
        seen.append([b["id"] for b in got])
    assert seen[0] != seen[1]            # each epoch reshuffles
    groups = {b["task_group"][0] for b in got}
    assert len(groups) > 1               # the choice draws from both


def test_loader_shards_and_drops_alike(dataset_dir):
    _, spec = dataset_dir
    ds = tdata.MimicitDataset(tyaml.tasks_from_spec(spec)["IMAGE_TEXT"],
                              TinyTokenizer(), patch_image_size=16)
    for kw in (dict(), dict(drop_last=False), dict(shuffle=False),
               dict(rank=2, world_size=3), dict(rank=1, world_size=3,
                                                drop_last=False)):
        port = tloader.MimicitLoader(ds, 3, seed=4, **kw)
        ref = jloader.MimicitLoader(ds, 3, seed=4, **kw)
        for epoch in (0, 5):
            port.epoch = ref.epoch = epoch
            assert port._indices() == ref._indices()
        assert len(port) == len(ref)


class _Failing:
    """A dataset whose `fail_at`-th item raises, as a broken image would."""

    def __init__(self, n=12, fail_at=5):
        self.n, self.fail_at = n, fail_at
        self.calls = 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __getitem__(self, i):
        self.calls += 1
        if i == self.fail_at:
            raise OSError(f"broken image at {i}")
        return {"i": i}

    def collate(self, samples, pad_to_multiple=1):
        return [s["i"] for s in samples]


def test_producer_failure_reaches_the_consumer():
    """The JAX producer thread dies without putting its end marker when an
    item raises, and its consumer waits on the queue forever
    (otter_tpu/data/loader.py:69-79). The port re-raises the error in the
    consumer, within 10 s."""
    loader = tloader.MimicitLoader(_Failing(), 2, shuffle=False,
                                   num_workers=2)
    box = {}

    def consume():
        try:
            box["got"] = list(loader)
        except OSError as e:
            box["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(10)
    assert not t.is_alive(), "the consumer still waits after 10 s"
    assert "broken image at 5" in str(box.get("error")), box
    assert time.perf_counter() - t0 < 10
    loader.producer.join(10)
    assert not loader.producer.is_alive()


def test_early_exit_releases_the_producer():
    """A consumer that stops after one batch leaves the JAX producer
    blocked on its full queue; the port's producer ends."""
    ds = _Failing(n=40, fail_at=-1)
    loader = tloader.MimicitLoader(ds, 2, shuffle=False, num_workers=1,
                                   prefetch=1)
    it = iter(loader)
    assert next(it) == [0, 1]
    time.sleep(0.2)                      # the producer fills the queue
    it.close()
    loader.producer.join(10)
    assert not loader.producer.is_alive()
    assert ds.calls < 40

    # the weighted loader closes its group loaders when it ends early
    multi = tloader.WeightedMultiLoader(
        [tloader.MimicitLoader(_Failing(n=40, fail_at=-1), 2, num_workers=1,
                               prefetch=1) for _ in range(2)], seed=0)
    mit = iter(multi)
    for _ in range(3):
        next(mit)
    mit.close()
    for l in multi.loaders:
        if l.producer is not None:
            l.producer.join(10)
            assert not l.producer.is_alive()


# ── transforms ───────────────────────────────────────────────────────

def _image_and_target(seed, h=48, w=64):
    from PIL import Image
    rng = np.random.default_rng(seed)
    img = Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
    boxes = np.asarray([[4, 6, 30, 40], [10, 2, 60, 20], [50, 30, 63, 47]],
                       np.float32)
    target = {"boxes": boxes, "labels": np.asarray([1, 2, 3]),
              "area": (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3]
                                                     - boxes[:, 1]),
              "masks": rng.random((3, h, w)) < 0.5}
    return img, target


def _assert_same(a, b):
    (ia, ta), (ib, tb) = a, b
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    assert (ta is None) == (tb is None)
    if ta is not None:
        assert sorted(ta) == sorted(tb)
        for k in tb:
            np.testing.assert_array_equal(np.asarray(ta[k]),
                                          np.asarray(tb[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_equal_jax(seed):
    img, target = _image_and_target(seed)
    for fn in ("crop", "hflip", "resize"):
        args = {"crop": ((5, 7, 30, 40),), "hflip": (),
                "resize": ((24, 40) if seed else 32,)}[fn]
        for t in (target, None):
            _assert_same(getattr(ttransforms, fn)(img, t, *args),
                         getattr(jtransforms, fn)(img, t, *args))
    _assert_same(ttransforms.resize(img, target, 40, max_size=50),
                 jtransforms.resize(img, target, 40, max_size=50))
    _assert_same(ttransforms.crop(img, target, (40, 60, 8, 4), delete=True),
                 jtransforms.crop(img, target, (40, 60, 8, 4), delete=True))

    def pipeline(m):
        return m.Compose([
            m.RandomHorizontalFlip(0.5), m.RandomResize([24, 32, 40],
                                                        max_size=64),
            m.RandomDistortion(prob=0.9), m.LargeScaleJitter(48, 0.3, 2.0),
            m.CenterCrop((40, 40))])

    for rep in range(4):
        random.seed(seed * 10 + rep)
        got = pipeline(ttransforms)(img, target)
        random.seed(seed * 10 + rep)
        want = pipeline(jtransforms)(img, target)
        _assert_same(got, want)
    _assert_same(ttransforms.ObjectCenterCrop((20, 24))(img, target),
                 jtransforms.ObjectCenterCrop((20, 24))(img, target))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    for m in (ttransforms, jtransforms):
        arr, _ = m.ToArray()(img)
        out, _ = m.Normalize(mean, std)(arr)
        if m is ttransforms:
            port = out
    np.testing.assert_array_equal(port, out)


# ── tokenizer adaptation, on a real HF fast tokenizer ───────────────

def _fresh_tokenizer(with_pad=False, with_eos=True):
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {w: i for i, w in enumerate(
        ["<unk>", "hello", "world", "a", "b", "c"])}
    if with_eos:
        vocab["</s>"] = len(vocab)
    if with_pad:
        vocab["<pad>"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    kw = {"unk_token": "<unk>"}
    if with_eos:
        kw["eos_token"] = "</s>"
    if with_pad:
        kw["pad_token"] = "<pad>"
    return transformers.PreTrainedTokenizerFast(tokenizer_object=tok, **kw)


@pytest.mark.parametrize("with_pad,with_eos,answer",
                         [(False, True, True), (True, True, True),
                          (False, False, True), (False, True, False)])
def test_adapt_for_otter_equal_jax(with_pad, with_eos, answer):
    from otter_tpu.data import tokenizer_adapt as jta
    from otter_tpu_torch.data import tokenizer_adapt as tta
    port_tok, ref_tok = (_fresh_tokenizer(with_pad, with_eos),
                         _fresh_tokenizer(with_pad, with_eos))
    got = tta.adapt_for_otter(port_tok, add_answer_token=answer)
    want = jta.adapt_for_otter(ref_tok, add_answer_token=answer)
    assert vars(got) == vars(want)
    assert len(port_tok) == len(ref_tok)
    text = "<image> hello <answer> world <|endofchunk|> c"
    assert port_tok(text, add_special_tokens=False).input_ids == \
        ref_tok(text, add_special_tokens=False).input_ids
    again = tta.adapt_for_otter(port_tok, add_answer_token=answer)
    assert again.added == 0 and again.new_vocab == got.new_vocab


def test_adapted_tokens_apply_to_the_port_config():
    from otter_tpu import config as jcfg
    from otter_tpu.data import tokenizer_adapt as jta
    from otter_tpu_torch import config as tcfg
    from otter_tpu_torch.data import tokenizer_adapt as tta
    tok = _fresh_tokenizer()
    res = tta.adapt_for_otter(tok)
    for cfgmod, mod in ((tcfg, tta), (jcfg, jta)):
        cfg = cfgmod.OtterConfig.tiny("mpt")
        base = cfg.replace(text=cfg.text.replace(
            vocab_size=len(tok) - res.added, extra_vocab=0))
        out = mod.AdaptedTokens(**vars(res)).apply_to(base)
        if cfgmod is tcfg:
            port = out.to_dict()
    assert port == out.to_dict()
    assert port["text"]["extra_vocab"] == res.added


def test_denoising_and_load_adapted_equal_jax(tmp_path):
    from otter_tpu.data import tokenizer_adapt as jta
    from otter_tpu_torch.data import tokenizer_adapt as tta
    a, b = _fresh_tokenizer(with_eos=False), _fresh_tokenizer(with_eos=False)
    ids = tta.adapt_for_denoising(a)
    assert ids == jta.adapt_for_denoising(b)
    assert len(ids) == tta.SENTINEL_COUNT and a.pad_token == "<pad>"
    assert a.sentinel_token_ids == ids
    _fresh_tokenizer().save_pretrained(str(tmp_path))
    tok, res = tta.load_adapted(str(tmp_path))
    rtok, rres = jta.load_adapted(str(tmp_path))
    assert vars(res) == vars(rres) and len(tok) == len(rtok)
    tok, sent = tta.load_adapted(str(tmp_path), denoising=True)
    assert sent == jta.load_adapted(str(tmp_path), denoising=True)[1]
