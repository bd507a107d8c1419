"""`multiwave_share.online` on synthetic span records: the share of the
stretch's kernel launches whose plan takes two or more waves, and nothing
where the launches carry no `waves` (a program before the attribute), the
program has no recorder, or the run has no trace."""
from types import SimpleNamespace

import pytest

from portbench.harness import spans as sp
from portbench.harness import trace as tr
from portbench.harness.context import Context
from portbench.harness.spec import Spec

T0 = 100.0  # the stretch opens here and lasts 10 s
NAME = "multiwave_share.online"


def _launch(start, end, **attrs):
    return SimpleNamespace(name="sampler.launch", start=T0 + start, end=T0 + end, id=None,
                           parent=None, tid=1, call=None, attrs=attrs)


def _read(spans, monkeypatch, traced=True):
    monkeypatch.setattr(sp, "recorded", lambda: spans)
    trace = tr.Trace([tr.DeviceOp("k", T0, T0 + 10.0, None)], T0, T0 + 10.0) if traced else None
    ctx = Context({}, {}, SimpleNamespace(trace=trace), [], 10.0, 0.0)
    return Spec().reader(NAME)(ctx)


def test_the_share_of_launches_in_two_or_more_waves(monkeypatch):
    spans = [_launch(1.0, 1.2, rows=256, waves=2, cluster_rows=16),
             _launch(2.0, 2.1, rows=128, waves=1, cluster_rows=16),
             _launch(3.0, 3.1, rows=256, waves=1, cluster_rows=24),
             _launch(4.0, 4.2, rows=512, waves=3, cluster_rows=24),
             _launch(-1.0, 0.5, rows=256, waves=2, cluster_rows=16),  # before the stretch
             _launch(9.9, 10.4, rows=256, waves=2, cluster_rows=16),  # open at its stop
             SimpleNamespace(name="service.chunk", start=T0 + 5.0, end=T0 + 5.1, id=None,
                             parent=None, tid=1, call=None, attrs=dict(waves=2))]
    assert _read(spans, monkeypatch) == pytest.approx(50.0)
    assert _read(spans[1:3], monkeypatch) == 0.0


def test_launches_without_waves_read_nothing(monkeypatch):
    # the CPU's plain version, or a program whose spans lack the attribute
    assert _read([_launch(1.0, 1.2, rows=256), _launch(2.0, 2.2, rows=64)], monkeypatch) is None
    assert _read([], monkeypatch) is None
    assert _read(None, monkeypatch) is None
    assert _read([_launch(1.0, 1.2, rows=256, waves=2)], monkeypatch, traced=False) is None
