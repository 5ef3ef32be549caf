"""tools/trace_step.py: the trace-to-metrics reduction on a hand-built
trace whose answer is known."""

import os
import sys
from types import SimpleNamespace as NS

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import trace_step  # noqa: E402


def _ev(name, start, dur):
    return NS(name=name, start_ns=float(start), duration_ns=float(dur))


def _planes(window=(1000, 11000)):
    host = NS(name="/host:CPU", lines=[NS(name="python", events=[
        _ev(trace_step.WINDOW, window[0], window[1] - window[0])])])
    stream = NS(name="Stream #7(Compute)", events=[
        _ev("fusion_1", 1000, 2000),       # overlaps the next kernel
        _ev("fusion_2", 2500, 1500),       # busy 1000..4000 -> 3000 ns
        _ev("MemcpyHtoD", 5000, 1000),     # a copy: busy, not a kernel
        _ev("fusion_1", 8000, 1000),
        _ev("fusion_1", 20000, 1000),      # after the window: ignored
    ])
    derived = NS(name="XLA Ops", events=[_ev("fusion_1", 1000, 9000)])
    return [host, NS(name="/device:GPU:0", lines=[stream, derived])]


def test_reduce_trace_known_answer():
    out = trace_step.reduce_trace(_planes(), nsteps=2)
    # window 10,000 ns; busy 3000 + 1000 (copy) + 1000 = 5000 ns
    assert out["window_us_per_step"] == pytest.approx(5.0)
    assert out["device_busy_us_per_step"] == pytest.approx(2.5)
    assert out["device_idle_share"] == pytest.approx(0.5)
    assert out["kernels_per_step"] == pytest.approx(1.5)
    assert out["copies_per_step"] == pytest.approx(0.5)
    assert out["distinct_kernels"] == 2
    top = out["top_kernels"][0]
    assert top["name"] == "fusion_1" and top["per_step"] == 1.0
    assert top["us_per_step"] == pytest.approx(1.5)


def test_reduce_trace_needs_the_window_span():
    planes = _planes()
    planes[0].lines[0].events = []
    with pytest.raises(ValueError, match="steady_window"):
        trace_step.reduce_trace(planes, nsteps=1)


def test_union_of_intervals():
    assert trace_step._union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace_step._union_ns([]) == 0
