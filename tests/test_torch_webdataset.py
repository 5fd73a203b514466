"""Port parity of the tar-shard pretraining pipelines
(`otter_tpu_torch.data.webdataset`) against the JAX package's
(`otter_tpu.data.webdataset`), both with their C++ decoders switched
off (decoding through PIL): batches from the same shards (images within 1e-6,
ids and masks exact, in order with one reader and as a multiset with
four), the shard lists per epoch, rank and worker, the MMC4 filters, and
a reader's failure, which the port raises where the JAX reader loses it."""

import base64
import io
import json
import random
import tarfile
import types
from collections import Counter

import numpy as np
import pytest
from PIL import Image

import otter_tpu.native
import otter_tpu_torch.native
from helpers import TinyTokenizer
from otter_tpu.data import webdataset as jwds
from otter_tpu_torch.data import webdataset as wds

MEDIA = TinyTokenizer.specials["<image>"]


@pytest.fixture(autouse=True)
def _pil_on_both_sides(monkeypatch):
    monkeypatch.setattr(otter_tpu.native, "available", lambda: False)
    monkeypatch.setattr(otter_tpu_torch.native, "available", lambda: False)


def _png(rng, n):
    buf = io.BytesIO()
    Image.fromarray((rng.random((n, n, 3)) * 255).astype(np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _pair_shard(path, rng, n, tag):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{tag}{i:04d}.jpg", _png(rng, 20 + i))
            _add(tf, f"{tag}{i:04d}.txt", f"caption {tag} {i} of a shard"
                 .encode())


def _doc(rng, i):
    """An MMC4 document: four sentences, three images matched to them (one
    under 10 KB, one under the similarity threshold on some documents)."""
    big = [_png(rng, 64) for _ in range(2)]
    small = _png(rng, 8)
    assert min(map(len, big)) > 11000 and len(small) < 10000
    infos = [{"image_base64": base64.b64encode(big[0]).decode(),
              "matched_sim": 0.5, "matched_text_index": 1},
             {"image_base64": base64.b64encode(small).decode(),
              "matched_sim": 0.9, "matched_text_index": 2},
             {"image_base64": base64.b64encode(big[1]).decode(),
              "matched_sim": 0.1 if i % 3 == 0 else 0.3,
              "matched_text_index": 3}]
    return {"text_list": [f"intro {i}", f"first image talk {i}",
                          f"small image talk {i}", f"second image {i}"],
            "image_info": infos}


def _mmc4_shard(path, rng, n, tag):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{tag}{i:04d}.json", json.dumps(_doc(rng, i)).encode())


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    for s in range(4):
        _pair_shard(str(d / f"l-{s}.tar"), rng, 5, f"l{s}_")
    for s in range(2):
        _mmc4_shard(str(d / f"m-{s}.tar"), rng, 6, f"m{s}_")
    return d


def _args(d, **kw):
    base = dict(laion_shards=str(d / "l-{0..3}.tar"),
                mmc4_shards=str(d / "m-{0..1}.tar"),
                cc3m_shards=str(d / "l-{2..3}.tar"), batch_size_laion=4,
                batch_size_mmc4=2, batch_size_cc3m=3,
                train_num_samples_laion=20, train_num_samples_mmc4=8,
                train_num_samples_cc3m=9, seed=3, rank=0, world_size=1,
                workers=1, mmc4_textsim_threshold=0.24, media_token_id=MEDIA,
                dataset_resampled=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_allclose(g["images"], r["images"], atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(g["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(g["attention_mask"],
                                      r["attention_mask"])


def test_braceexpand_and_tar_samples_match_jax(shards):
    for pat in ("s-{00..11}.tar", "{a,b}/x{1..2}", "p/{0..3}-{x,y}.tar",
                "plain.tar"):
        assert wds.braceexpand(pat) == jwds.braceexpand(pat)
    path = str(shards / "l-0.tar")
    assert list(wds.tar_samples(path)) == list(jwds.tar_samples(path))


@pytest.mark.parametrize("kind", ["laion", "mmc4", "cc3m"])
@pytest.mark.parametrize("epoch", [0, 1])
def test_batches_match_jax_in_order(shards, kind, epoch):
    """One reader: the same shard order, shuffle buffer and batches. The
    pipelines' label-free outputs equal the JAX pipeline's."""
    out = []
    for mod in (wds, jwds):
        info = mod.get_data(_args(shards), TinyTokenizer(), kind,
                            epoch=epoch)
        info.dataloader.num_parallel_shards = 1
        info.dataloader.shuffle_buffer = 4
        out.append((info, list(info.dataloader)))
    (info, got), (jinfo, ref) = out
    assert (info.num_batches, info.num_samples) == (jinfo.num_batches,
                                                    jinfo.num_samples)
    _assert_batches_equal(got, ref)
    if kind == "mmc4":
        assert got[0]["images"].shape[1:] == (5, 1, 3, 224, 224)
        assert (got[0]["input_ids"] == MEDIA).sum(-1).min() >= 1


@pytest.mark.parametrize("resampled", [False, True])
def test_shard_lists_per_epoch_rank_and_worker_match_jax(shards, resampled):
    names = [f"s{i}" for i in range(11)]
    seen = set()
    for epoch in range(3):
        for rank, world in ((0, 1), (0, 2), (1, 2), (2, 3)):
            for worker, workers in ((0, 1), (1, 2)):
                kw = dict(resampled=resampled, seed=7, epoch=epoch,
                          rank=rank, world_size=world, worker=worker,
                          num_workers=workers)
                got = wds.ShardPipeline(names, None, 1, **kw)._shard_list()
                assert got == jwds.ShardPipeline(names, None, 1,
                                                 **kw)._shard_list()
                seen.add(tuple(got))
    # (resampling draws one list an epoch, for every rank and worker)
    assert len(seen) == 3 if resampled else len(seen) > 10


def test_parallel_readers_give_the_same_multiset(shards):
    """Four readers over four shards: every sample once (20 = 5 batches
    of 4, none dropped), the multiset of rows the JAX pipeline's."""
    rows = []
    for mod in (wds, jwds, wds):
        pipe = mod.ShardPipeline(
            mod.braceexpand(str(shards / "l-{0..3}.tar")),
            mod.make_pair_preprocessor(TinyTokenizer(), patch_size=16),
            batch_size=4, shuffle_buffer=8, num_parallel_shards=4)
        batches = list(pipe)
        assert len(batches) == 5
        rows.append(Counter(tuple(r) for b in batches
                            for r in b["input_ids"].tolist()))
    assert rows[0] == rows[1] == rows[2]
    assert sum(rows[0].values()) == 20


def test_mmc4_filters_and_text_match_jax(shards):
    """The 10 KB and similarity filters, the pad to five images, the
    <|endofchunk|> / <image> insertion and the single-image drop, drawn
    from the same `random.Random`: equal to JAX's, document by
    document."""
    rng = np.random.default_rng(9)
    docs = [{"json": json.dumps(_doc(rng, i)).encode()} for i in range(12)]
    kw = dict(media_token_id=MEDIA, patch_size=16, sim_threshold=0.24)
    ours = wds.make_interleaved_preprocessor(
        TinyTokenizer(), rng=random.Random(1), **kw)
    ref = jwds.make_interleaved_preprocessor(
        TinyTokenizer(), rng=random.Random(1), **kw)
    dropped = kept = 0
    for doc in docs:
        try:
            r = ref(doc)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ours(doc)
            dropped += 1
            continue
        g = ours(doc)
        kept += 1
        np.testing.assert_allclose(g[0], r[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])
        assert g[0].shape == (5, 1, 3, 16, 16)
        n_img = int((g[1] == MEDIA).sum())
        assert n_img in (1, 2) and not g[0][n_img:].any()
    assert dropped and kept


def test_a_reader_failure_reaches_the_consumer(shards, tmp_path):
    """A shard that cannot be read, under a handler that re-raises: with
    four readers the JAX pipeline loses the exception with its reader
    thread and the epoch comes up short; the port raises it in the
    consumer, as the sequential path of both does."""
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"\x00not a tar archive" * 64)
    paths = [str(shards / f"l-{s}.tar") for s in range(3)] + [str(bad)]

    def run(mod, parallel):
        pipe = mod.ShardPipeline(
            paths, mod.make_pair_preprocessor(TinyTokenizer(),
                                              patch_size=16),
            batch_size=1, shuffle_buffer=0,
            num_parallel_shards=4 if parallel else 1,
            handler=lambda e: False)
        return sum(1 for _ in pipe)

    import threading
    hook, threading.excepthook = threading.excepthook, lambda args: None
    try:
        assert run(jwds, True) <= 15      # no error, some samples lost
    finally:
        threading.excepthook = hook
    with pytest.raises(tarfile.ReadError):
        run(jwds, False)
    for parallel in (True, False):
        with pytest.raises(tarfile.ReadError):
            run(wds, parallel)


def test_workers_read_every_shard_where_jax_reads_one_in_workers(shards):
    """`--workers 4` over four LAION shards of five pairs: the JAX
    constructor's pipeline, iterated by one process as worker 0 of 4,
    reads one shard (5 pairs); the port's reads all four with four
    reader threads (20 pairs, the multiset of the one-reader run)."""
    args = _args(shards, workers=4, batch_size_laion=1)
    ref = list(jwds.get_data(args, TinyTokenizer(), "laion").dataloader)
    got = list(wds.get_data(args, TinyTokenizer(), "laion").dataloader)
    assert len(ref) == 5 and len(got) == 20
    one = wds.get_data(_args(shards, workers=1, batch_size_laion=1),
                       TinyTokenizer(), "laion").dataloader
    assert one.num_parallel_shards == 1
    rows = lambda bs: Counter(tuple(b["input_ids"][0]) for b in bs)
    assert rows(got) == rows(list(one))
    assert set(rows(ref)) < set(rows(got))
