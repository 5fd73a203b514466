"""The port's C++ batch image decoder (`otter_tpu_torch.native`): built
into `otter_tpu_torch/_build/` under one file lock, held to the port's PIL
path under the bars of `tests/test_native_preproc.py` (99% of pixels
within 4 u8 steps; the PIL path is the JAX package's to the last bit),
and wired into the tar-shard pipelines and the MIMIC-IT dataset:
`native=True` decodes through it and raises where it cannot be had,
`native="auto"` takes PIL there. The JAX package's decoder is never built
here: its side goes through PIL."""

import base64
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from helpers import TinyTokenizer, write_mimicit_fixture
from otter_tpu.data import mimicit as jmimicit
from otter_tpu_torch import native
from otter_tpu_torch.data import webdataset as wds
from otter_tpu_torch.data import yaml_spec
from otter_tpu_torch.data.mimicit import MimicitDataset, preprocess_image
from otter_tpu_torch.data.templates import FLAMINGO_MEAN, FLAMINGO_STD

MEDIA = TinyTokenizer.specials["<image>"]
BAR = 4 / 255 / min(FLAMINGO_STD)      # test_native_preproc.py's bar


def _within_bar(out, ref):
    diff = np.abs(np.asarray(out) - np.asarray(ref))
    assert np.percentile(diff, 99) < BAR, float(diff.max())


def _img_bytes(rng, fmt, h=180, w=240, smooth=False):
    """An encoded image of noise, or (`smooth`) of a few low-frequency
    waves, as photographs are: libjpeg's scaled decode, which the training
    pipelines opt into, keeps within the bar on such an image at a
    photograph's size (480 x 640 to 224 decodes at 1/2) and not on noise
    or at 5/8 of a small image."""
    if smooth:
        y, x = np.mgrid[0:h, 0:w] / max(h, w)
        f = rng.uniform(1, 4, (3, 2))
        arr = 127.5 * (1 + np.stack([np.sin(2 * np.pi * (f[c, 0] * x + f[c, 1]
                                                          * y) + c)
                                     for c in range(3)], -1))
    else:
        arr = rng.random((h, w, 3)) * 255
    img = Image.fromarray(arr.astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, fmt, quality=95)
    return buf.getvalue()


def _pil(data, size):
    return preprocess_image(Image.open(io.BytesIO(data)).convert("RGB"),
                            size)


@pytest.fixture
def unavailable(monkeypatch):
    """The library as on a host without libjpeg's headers."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error",
                        "RuntimeError: jpeglib.h: No such file or directory")


def test_builds_into_the_port_build_directory():
    assert native.available() and native.unavailable_reason() is None
    lib = native._target()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and \
        native.BUILD_DIR.parent.name == "otter_tpu_torch"
    assert lib.is_file() and not list(native.BUILD_DIR.glob("*.tmp"))


def test_concurrent_first_builds_build_once(tmp_path):
    """Three processes ask for the library at once in an empty build
    directory: one compiles it under the file lock, every one loads it."""
    import shutil
    build = tmp_path / "build"
    log = tmp_path / "compiles.log"
    cxx = tmp_path / "cxx"            # g++, counting its calls
    cxx.write_text(f"#!/bin/sh\necho x >> {log}\n"
                   f"exec {shutil.which('g++')} \"$@\"\n")
    cxx.chmod(0o755)
    code = ("import sys, pathlib\n"
            "from otter_tpu_torch import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "print(native.available(), native.unavailable_reason())\n")
    env = dict(os.environ, PYTHONPATH=str(native.BUILD_DIR.parents[1]),
               CXX=str(cxx))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs == [["True", "None"]] * 3
    assert log.read_text().split() == ["x"]
    assert [f.name for f in build.glob("*.so")] == [native._target().name]
    assert not list(build.glob("*.tmp"))


def test_a_library_that_does_not_load_is_built_again(tmp_path,
                                                     monkeypatch):
    """A file at the library's path that does not load (one built on a
    host with other shared libraries, in a copied checkout) is built
    again here."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    native._target().write_bytes(b"built for another host")
    assert native.available(), native.unavailable_reason()
    assert native._target().read_bytes()[:4] == b"\x7fELF"


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_matches_pil(rng, fmt):
    data = _img_bytes(rng, fmt)
    out, status = native.preprocess_batch([data], 224, FLAMINGO_MEAN,
                                          FLAMINGO_STD)
    assert status.tolist() == [0]
    ref = _pil(data, 224)
    _within_bar(out[0], ref)
    # the port's PIL path is the JAX package's
    np.testing.assert_array_equal(ref, jmimicit.preprocess_image(
        Image.open(io.BytesIO(data)).convert("RGB"), 224))


def test_base64_and_errors(rng):
    data = _img_bytes(rng, "PNG", 64, 64)
    b64 = base64.urlsafe_b64encode(data)
    out, status = native.preprocess_batch([b64, b"not an image"], 32,
                                          FLAMINGO_MEAN, FLAMINGO_STD,
                                          is_base64=True)
    assert status[0] == 0 and status[1] != 0
    _within_bar(out[0], _pil(data, 32))


def test_unavailable_library_raises_with_its_reason(unavailable):
    assert not native.available()
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.preprocess_batch([b"x"], 8, FLAMINGO_MEAN, FLAMINGO_STD)
    assert native.resolve("auto") is False and native.resolve(False) is False
    with pytest.raises(RuntimeError, match="unavailable"):
        native.resolve(True)


# ── the tar-shard pipelines ─────────────────────────────────────────

def _mmc4_doc(rng, n_images=2):
    imgs = [{"image_base64": base64.b64encode(
        _img_bytes(rng, "JPEG", 480, 640, smooth=True)).decode(),
        "matched_text_index": i,
        "matched_sim": 0.3} for i in range(n_images)]
    return {"json": json.dumps({
        "text_list": ["a cat sits", "on a mat", "in the sun"],
        "image_info": imgs}).encode()}


def test_interleaved_preprocessor_native_matches_pil(rng):
    doc = _mmc4_doc(rng)
    make = lambda native_: wds.make_interleaved_preprocessor(  # noqa: E731
        TinyTokenizer(), media_token_id=MEDIA, patch_size=224,
        single_image_drop=0.0, native=native_)
    got, want = make(True)(doc), make(False)(doc)
    assert got[0].shape == want[0].shape == (5, 1, 3, 224, 224)
    _within_bar(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _laion_shard(tmp_path, rng, n=4):
    path = str(tmp_path / "laion-0.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for ext, data in (("jpg", _img_bytes(rng, "JPEG", 480, 640,
                                                 smooth=True)),
                              ("txt", f"a photo of thing {i}".encode())):
                info = tarfile.TarInfo(f"{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return path


def test_pair_pipeline_decodes_whole_batches_natively(tmp_path, rng):
    """With native=True a LAION sample carries its bytes to the batch,
    which decodes in one call (scaled DCT decode: the bar holds); a row
    the decoder rejects decodes through PIL."""
    shard = _laion_shard(tmp_path, rng)
    batches = {}
    for choice in (True, False):
        pre = wds.make_pair_preprocessor(TinyTokenizer(), patch_size=224,
                                         native=choice)
        pipe = wds.ShardPipeline([shard], pre, 4, shuffle_buffer=0,
                                 num_parallel_shards=1)
        batches[choice] = next(iter(pipe))
    got, want = batches[True], batches[False]
    assert got["images"].shape == want["images"].shape == (4, 1, 1, 3, 224,
                                                           224)
    _within_bar(got["images"], want["images"])
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    raw = [_img_bytes(rng, "PNG", 40, 40), b"\xff\xd8 a broken jpeg"]
    with pytest.raises(Exception):
        wds._native_decode(raw, 16)         # PIL cannot read it either
    good = wds._native_decode(raw[:1] * 2, 16)
    _within_bar(good, np.stack([_pil(raw[0], 16)] * 2))


def test_pipelines_refuse_native_true_where_it_cannot_be_had(unavailable):
    for make in (wds.make_pair_preprocessor,
                 lambda t, native: wds.make_interleaved_preprocessor(
                     t, media_token_id=MEDIA, native=native)):
        with pytest.raises(RuntimeError, match="jpeglib.h"):
            make(TinyTokenizer(), native=True)
        make(TinyTokenizer(), native="auto")   # PIL there


# ── the MIMIC-IT dataset ────────────────────────────────────────────

@pytest.fixture
def tasks(tmp_path, rng):
    spec = yaml_spec.load_yaml(write_mimicit_fixture(tmp_path, rng, n=3))
    return yaml_spec.tasks_from_spec(spec)["IMAGE_TEXT"]


def _dataset(tasks, **kw):
    return MimicitDataset(tasks, TinyTokenizer(), patch_image_size=16,
                          max_seq_len=40, **kw)


def test_mimicit_native_true_matches_pil(tasks):
    ours = _dataset(tasks, native=True)
    ref = _dataset(tasks, native=False)
    assert ours.native and not ref.native
    for i in range(len(ours)):
        got, want = ours[i], ref[i]
        _within_bar(got["patch_images"], want["patch_images"])
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


def test_mimicit_takes_pil_only_for_a_rejected_image(tasks, monkeypatch):
    """A non-zero status sends the sample through PIL; any other error of
    the decoder propagates (the JAX dataset swallows it)."""
    ds = _dataset(tasks, native=True)
    ref = _dataset(tasks, native=False)[0]["patch_images"]

    def rejected(bufs, size, *a, **k):
        return (np.zeros((len(bufs), 3, size, size), np.float32),
                np.ones(len(bufs), np.int32))

    monkeypatch.setattr(native, "preprocess_batch", rejected)
    np.testing.assert_array_equal(ds[0]["patch_images"], ref)

    def broken(*a, **k):
        raise ValueError("a decoder bug")

    monkeypatch.setattr(native, "preprocess_batch", broken)
    with pytest.raises(ValueError, match="decoder bug"):
        ds[0]


def test_mimicit_native_true_raises_where_it_cannot_be_had(tasks,
                                                           unavailable):
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        _dataset(tasks, native=True)
    assert not _dataset(tasks).native      # "auto": PIL


# ── libjpeg's scaled decode at a small scale ────────────────────────

def _jax_decoder(monkeypatch, path, flags=None):
    """The JAX package's decoder, loaded from `path` by its own loader:
    built there by its own build (g++ -march=native), or first compiled
    with `flags` (the port's)."""
    import subprocess
    from otter_tpu import native as jnative
    if flags is not None:
        subprocess.run(["g++", *flags, jnative._SRC, "-o", str(path),
                        *native.LIBS], check=True, timeout=300)
    monkeypatch.setattr(jnative, "_SO", str(path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def test_small_scaled_decode_pins_its_error(tmp_path, monkeypatch):
    """A smooth 60 x 80 JPEG to 32 with libjpeg's scaled decode (5/8, as
    the training pipelines ask): the port's output is the JAX package's
    decoder's, bit for bit where both are built with the port's flags and
    within 1e-5 of the JAX build's own (-march=native contracts its float
    products otherwise); against PIL, 53.4% of the values stray by more
    than 4 u8 steps and the 99th percentile by 24.9 steps (ROADMAP Queue
    3), pinned at 60% and 28 steps so that a change to it shows, where the
    full decode stays within 1 step."""
    data = _img_bytes(np.random.default_rng(0), "JPEG", 60, 80, smooth=True)
    args = ([data], 32, FLAMINGO_MEAN, FLAMINGO_STD)
    out, status = native.preprocess_batch(*args, scaled_decode=True)
    assert status.tolist() == [0]
    same = _jax_decoder(monkeypatch, tmp_path / "flags.so", native.CXX_FLAGS)
    np.testing.assert_array_equal(out, same.preprocess_batch(
        *args, scaled_decode=True)[0])
    own = _jax_decoder(monkeypatch, tmp_path / "own.so")
    np.testing.assert_allclose(out, own.preprocess_batch(
        *args, scaled_decode=True)[0], atol=1e-5, rtol=0)
    step = 1 / 255 / np.asarray(FLAMINGO_STD)[:, None, None]
    steps = np.abs(out[0] - _pil(data, 32)) / step
    assert 0.45 < (steps > 4).mean() < 0.60
    assert np.percentile(steps, 99) < 28
    full = np.abs(native.preprocess_batch(*args)[0][0] - _pil(data, 32))
    assert (full / step).max() < 1
