"""The kernels' first use under threads (`otter_tpu_torch/_build.py`): the
serving worker decodes several requests on executor threads, so two
threads may ask for an unbuilt kernel at once, and every launch adds to a
shared counter. A fake compiler (a script that writes its `-o` file)
stands in for nvcc, which this machine lacks."""

import stat
import sys
import threading

import pytest

from otter_tpu_torch import _build

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)          # long enough for the other thread to arrive
with open(out, "wb") as f:
    f.write(b"not a real library")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A CUDA_HOME whose bin/nvcc is the fake compiler, and `_build`
    pointed at a source directory holding `k.cu` and a build directory of
    its own. Returns the file the compiler logs each run to."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc_runs.txt"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def _in_threads(fn, n: int):
    """Run fn() on n threads released together; their exceptions."""
    barrier = threading.Barrier(n)
    errors = []

    def run():
        barrier.wait()
        try:
            fn()
        except Exception as e:   # reported to the test below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_two_threads_build_one_library_once(fake_toolchain):
    assert _in_threads(lambda: _build.build(["k"]), 2) == []
    built = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    assert len(built) == 1 and built[0].startswith("k-") \
        and built[0].endswith(".so"), built        # no temporary left
    assert len(fake_toolchain.read_text().splitlines()) == 1
    assert _build.build(["k"]) == {}               # built: nothing to do


def test_edited_source_is_built_again(fake_toolchain):
    _build.build(["k"])
    (_build.CSRC / "k.cu").write_text("// another kernel\n")
    assert set(_build.build(["k"])) == {"k"}
    assert len(list(_build.BUILD_DIR.glob("k-*.so"))) == 2


def test_failed_build_raises_and_leaves_no_library(fake_toolchain):
    (_build.CSRC / "bad.cu").write_text("// fails\n")
    nvcc = _build.Path(_build._nvcc())
    nvcc.write_text("#!/bin/sh\necho 'error: bad.cu' >&2\nexit 1\n")
    errors = _in_threads(lambda: _build.build(["bad"]), 2)
    assert len(errors) == 2 and all("nvcc failed for bad.cu" in str(e)
                                    for e in errors)
    assert not list(_build.BUILD_DIR.glob("bad-*.so"))


def test_count_launch_loses_no_count():
    """Eight threads adding 2000 launches each to one wrapper's counters,
    with the interpreter switching threads every microsecond: the totals
    are exact (a lost update would break them)."""

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_int4 = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(2000):
                _build.count_launch(wrapper, int4=bool(i % 2))

        assert _in_threads(work, 8) == []
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16000
    assert wrapper.launches_int4 == 8000
