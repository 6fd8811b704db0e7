"""The kernel build module: a source is compiled once, whatever the threads.

``_build.load`` is called from the main thread while ``load_later`` may be
building the same source on another; the compile step is replaced by a slow
stand-in, so this runs without nvcc.
"""

import threading
import time

from iseg_tpu_torch.ops.kernels import _build


def _slow_stand_in(calls):
    def compile_and_load(source):
        calls.append(source)
        time.sleep(0.2)
        return object()
    return compile_and_load


def test_torch_build_load_compiles_a_source_once_across_threads(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_LOCKS", {})
    monkeypatch.setattr(_build, "_compile_and_load", _slow_stand_in(calls))
    pending = _build.load_later(["a.cu"])
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load("a.cu")))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (later,) = pending.result(timeout=10)
    assert calls == ["a.cu"]
    assert all(g is later for g in got)


def test_torch_build_load_later_returns_before_the_build_ends(monkeypatch):
    calls, release = [], threading.Event()

    def blocked(source):
        calls.append(source)
        release.wait(10)
        return source

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_LOCKS", {})
    monkeypatch.setattr(_build, "_compile_and_load", blocked)
    pending = _build.load_later(["a.cu", "b.cu"])
    assert not pending.done()
    release.set()
    assert pending.result(timeout=10) == ["a.cu", "b.cu"]
    assert sorted(calls) == ["a.cu", "b.cu"]
