"""The trace reader on a hand-made chrome trace."""

import json

import pytest

from gsbench import roofline, trace


def ev(cat, name, ts, dur, corr=None, **extra):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    e.update(extra)
    return e


def hand_trace():
    return [
        ev("user_annotation", trace.WINDOW, 100.0, 100.0),
        ev("user_annotation", "train_step/forward", 100.0, 30.0),
        ev("user_annotation", "train_step/backward", 130.0, 40.0),
        ev("cpu_op", "aten::sort", 101.0, 5.0),
        ev("cpu_op", "aten::item", 160.0, 35.0),
        # a launch before the window: not counted
        ev("cuda_runtime", "cudaLaunchKernel", 90.0, 1.0, corr=1),
        ev("kernel", "early", 95.0, 10.0, corr=1),
        # forward: two kernels
        ev("cuda_runtime", "cudaLaunchKernel", 102.0, 1.0, corr=2),
        ev("kernel", "void gs::fwd_kernel<gs::StreamSlots, true, false>()",
           110.0, 10.0, corr=2),
        ev("cuda_runtime", "cudaMemsetAsync", 105.0, 1.0, corr=3),
        ev("gpu_memset", "Memset (Device)", 120.0, 5.0, corr=3),
        # backward: one kernel, overlapping the memset by 1 us
        ev("cuda_runtime", "cudaLaunchKernel", 131.0, 1.0, corr=4),
        ev("kernel", "stream_bwd_fast_kernel<false>", 124.0, 26.0, corr=4),
        # a synchronise: not a launch
        ev("cuda_runtime", "cudaDeviceSynchronize", 170.0, 29.0, corr=5),
    ]


def test_summary_by_hand(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": hand_trace()}))
    s = trace.summarize(trace.load(str(path)),
                        ("train_step/forward", "train_step/backward"))
    assert s.window_us == 100.0
    assert s.launches == 3 and s.missing == 0
    # busy: [110, 150) = 40 us
    assert s.busy_us == pytest.approx(40.0)
    assert s.range_us == {"train_step/forward": 15.0,
                          "train_step/backward": 26.0}
    # gaps: [100, 110) under aten::sort, [150, 200) under aten::item
    assert [round(us) for _, us in s.gaps] == [50, 10]
    assert s.gaps[0][0] == "aten::item" and s.gaps[1][0] == "aten::sort"
    top = trace.top_ops(s)
    assert top[0] == ["stream_bwd_fast_kernel<false>", 26e-6]


def test_missing_record_reads_none():
    events = hand_trace()
    events = [e for e in events if e.get("args", {}).get("correlation") != 4
              or e["cat"] != "kernel"]
    s = trace.summarize(events, ("train_step/forward",
                                 "train_step/backward"))
    assert s.missing == 1
    assert s.range_us["train_step/backward"] is None
    assert s.range_us["train_step/forward"] == 15.0


class FakeRun:
    def __init__(self, summary):
        self.summary = summary
        self.window_steps = 1
        self.window_s = 1e-4
        self.work = [(0, None)]


def test_readers_on_the_hand_trace():
    s = trace.summarize(hand_trace(), ("train_step/forward",
                                       "train_step/backward"))
    run = FakeRun(s)
    assert roofline.idle_pct(run) == pytest.approx(60.0)
    assert roofline.launches(run) == 3
    assert roofline.range_ms(run, "train_step/backward") == 0.026
    # the kernel's least time against its one record
    share = roofline.kernel_share(run, roofline.fwd_kernel(True),
                                  lambda w: 5e-6)
    assert share == pytest.approx(50.0)
    assert roofline.kernel_share(run, roofline.fwd_kernel(False),
                                 lambda w: 5e-6) is None
    assert roofline.kernel_share(run, roofline.b3b,
                                 lambda w: 13e-6) == pytest.approx(50.0)
