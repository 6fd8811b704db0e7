"""The port's ``utils/summary.py`` (a copy) and ``utils/profiling.py``
against ``iseg_tpu.utils``: event files byte for byte for the same scalars
and wall time, records read back, the CSV, the step timer. On the CPU."""

import os
import types

import numpy as np
import pytest
import torch

from iseg_tpu.utils import profiling as jprof
from iseg_tpu.utils import summary as jsum
from iseg_tpu_torch.utils import profiling as tprof
from iseg_tpu_torch.utils import summary as tsum

torch.set_num_threads(1)

SCALARS = [("train/loss", 1.25, 0), ("train/loss", 0.5, 7), ("eval/mean_iou", 0.731, 7),
           ("train/learning_rate", -3e-5, 2 ** 40), ("epoch/seconds", float("inf"), 9)]


@pytest.mark.parametrize("tag,value,step", SCALARS)
def test_torch_encoded_events_match_jax(tag, value, step):
    assert (tsum.encode_scalar_event(tag, value, step, wall_time=1.5e9)
            == jsum.encode_scalar_event(tag, value, step, wall_time=1.5e9))
    assert tsum._tfrecord(b"abc") == jsum._tfrecord(b"abc")


def test_torch_event_file_bytes_match_jax(tmp_path, monkeypatch):
    for mod in (tsum, jsum):  # the modules' clocks, not the process's
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.25))
    paths = []
    for name, mod in (("t", tsum), ("j", jsum)):
        with mod.SummaryWriter(str(tmp_path / name)) as w:
            for tag, value, step in SCALARS[:3]:
                w.add_scalar(tag, value, step)
            w.add_scalars({"a": 1.0, "b": 2.0}, 11)
            paths.append(w.path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    rows = tsum.read_event_scalars(paths[0])
    assert rows == jsum.read_event_scalars(paths[1])
    assert [(s, t) for s, t, _ in rows] == [(0, "train/loss"), (7, "train/loss"),
                                             (7, "eval/mean_iou"), (11, "a"), (11, "b")]
    np.testing.assert_allclose([v for _, _, v in rows], [1.25, 0.5, 0.731, 1.0, 2.0], rtol=1e-7)


def test_torch_scalar_logger_csv_and_corrupt_file(tmp_path):
    logger = tsum.ScalarLogger(str(tmp_path))
    logger.log({"x": 1.0, "y": 2.5}, 3)
    logger.close()
    lines = open(os.path.join(tmp_path, "scalars.csv")).read().splitlines()
    assert lines[0] == "step,tag,value,wall_time" and lines[1].startswith("3,x,1.0,")
    path = logger.writer.path
    assert tsum.read_event_scalars(path) == [(3, "x", 1.0), (3, "y", 2.5)]
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        tsum.read_event_scalars(path)
    assert tsum.crc32c(b"123456789") == jsum.crc32c(b"123456789") == 0xE3069283


def test_torch_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.1, 0.3, 0.35, 1.35, 1.4] * 2)
    for mod in (tprof, jprof):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    summaries = []
    for mod in (tprof, jprof):
        timer = mod.StepTimer(window=4)
        for _ in range(6):
            timer.tick()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 4 and summaries[0]["p90_s"] == pytest.approx(1.0)


def test_torch_profile_trace_writes_chrome_trace(tmp_path):
    with tprof.profile_trace(str(tmp_path)):
        torch.ones(8).add_(1)
    traces = [f for f in os.listdir(tmp_path) if f.startswith("trace.")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0
