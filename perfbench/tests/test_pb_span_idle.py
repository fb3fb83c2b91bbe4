"""The device's idle time split over the port's spans (span_idle.py), on
fabricated device operations and ranges with known gaps and nesting; and
the port-counter readers on fabricated records."""

import sys
import types

import pytest

from perfbench import port_counters, span_idle, spec


def test_idle_by_span_nested_ranges_and_known_gaps():
    # device busy [0,10) [20,30) [35,40) [60,100): gaps [10,20) [30,35) [40,60)
    dev = [(0, 10), (20, 30), (22, 28), (35, 40), (60, 100)]
    ranges = [(5, 90, "amgb"), (8, 50, "step"), (12, 16, "nd.direction"),
              (14, 15, "nd.factor"), (32, 45, "step.line_search"), (55, 58, "gc")]
    got = span_idle.idle_by_span(dev, ranges)
    assert got["idle_s"] == pytest.approx(35e-9)
    exc = {k: round(v * 1e9) for k, v in got["exclusive"].items()}
    # step owns [10,12) [16,20) [30,32) [45,50); nd.direction [12,14) [15,16);
    # its child [14,15); the line search [32,35) [40,45); amgb [50,55) [58,60)
    assert exc == {"step": 13, "nd.direction": 3, "nd.factor": 1, "step.line_search": 8,
                   "amgb": 7, "gc": 3, span_idle.OUTSIDE: 0}
    inc = {k: round(v * 1e9) for k, v in got["inclusive"].items()}
    assert inc["nd.direction"] == 4 and inc["step"] == 25 and inc["amgb"] == 35
    assert sum(got["exclusive_pct"].values()) == pytest.approx(100.0)
    assert got["inclusive_pct"]["amgb"] == pytest.approx(100.0)


def test_idle_outside_every_range_and_no_device_work():
    got = span_idle.idle_by_span([(0, 10), (30, 40)], [(12, 15, "step")])
    assert got["exclusive"][span_idle.OUTSIDE] == pytest.approx(17e-9)
    assert got["exclusive_pct"]["step"] == pytest.approx(15.0)
    assert span_idle.idle_by_span([], [(0, 1, "step")])["idle_s"] == 0.0


def _record(calls, solves):
    """A run record whose timed solves are [start, end] and the port's
    telemetry module holding `calls` as (start_ns, end_ns, counters)."""
    mod = types.SimpleNamespace(SOLVES=calls)
    rec = types.SimpleNamespace(solves=[dict(start=a, end=b) for a, b in solves])
    return rec, mod


@pytest.fixture
def telemetry_module(monkeypatch):
    def install(mod):
        monkeypatch.setitem(sys.modules, port_counters.MODULE, mod)
    monkeypatch.delitem(sys.modules, port_counters.MODULE, raising=False)
    return install


CALLS = [
    (0.5e9, 0.9e9, {"newton_steps": 7, "builds.ctx": 1, "builds.nd_level": 2}),  # the warm-up
    (1.1e9, 1.9e9, {"newton_steps": 10, "ls_trials": 13, "host_syncs.step": 10,
                    "host_syncs.ls.trial": 13, "dense_shift_retries": 2}),
    (2.1e9, 2.9e9, {"newton_steps": 30, "ls_trials": 35, "host_syncs.step": 30,
                    "host_syncs.ls.trial": 35, "host_syncs.dense.info": 5, "nd_fallbacks": 1,
                    "builds.hvp_schedule": 1}),
]


@pytest.mark.parametrize("metric, want", [
    ("host_syncs_per_step", (10 + 13 + 30 + 35 + 5) / 40),
    ("ls_trials_per_step", 48 / 40),
    ("factor_retries_per_solve", 3 / 2),
    ("builds_per_solve", 1 / 2),
])
def test_counter_readers(telemetry_module, metric, want):
    read = spec.reader(metric)
    rec, mod = _record(CALLS, [(1.0, 2.0), (2.0, 3.0)])
    assert read(rec) is None  # a port without telemetry: nothing to read, no error
    telemetry_module(mod)
    assert read(rec) == pytest.approx(want)
    # a timed solve with no amgb call of its own inside it: left out
    assert read(_record(CALLS, [(1.0, 2.0), (3.0, 4.0)])[0]) is None


def test_builds_read_zero_in_a_warm_window(telemetry_module):
    rec, mod = _record(CALLS[1:2], [(1.0, 2.0)])
    telemetry_module(mod)
    assert spec.reader("builds_per_solve")(rec) == 0.0
