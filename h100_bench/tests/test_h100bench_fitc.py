"""The FITC fit cell ``fitc_400k.fit``: found by name through the manifest,
and its two span readers (``fitc_panel_ms.fit``, ``fitc_nsum_ms.fit``) on
synthetic spans and on a program without them."""
from types import SimpleNamespace

import pytest

from hb import spans as S
from hb.manifest import Manifest
from hb.trace import Trace

CELL = "fitc_400k.fit"
NEW = ("fitc_panel_ms.fit", "fitc_nsum_ms.fit")


def _span(sid, name, device_ns):
    return SimpleNamespace(id=sid, name=name, parent=None, attrs={},
                           start=0, end=1000, device_ns=device_ns)


def _ctx():
    fits = [dict(nit=2, nfev=3), dict(nit=1, nfev=1)]
    return SimpleNamespace(trace=Trace(t0=0.0, t1=1000.0),
                           window=dict(fits=fits))


@pytest.fixture
def reader():
    return Manifest().reader


def test_readers_sum_the_device_time_over_the_evaluations(reader,
                                                          monkeypatch):
    spans = ([_span(i, "lcgp.fitc.panel", 2_000_000) for i in range(4)]
             + [_span(10 + i, "lcgp.fitc.nsum", 250_000) for i in range(20)]
             + [_span(40, "lcgp.fit.eval", None)])
    monkeypatch.setattr(S, "recorded", lambda: spans)
    # 4 evaluations: 8 ms of panels, 5 ms of sums
    assert reader("fitc_panel_ms.fit")(_ctx()) == pytest.approx(2.0)
    assert reader("fitc_nsum_ms.fit")(_ctx()) == pytest.approx(1.25)


def test_spans_without_device_time_read_none(reader, monkeypatch):
    spans = [_span(1, "lcgp.fitc.panel", None),
             _span(2, "lcgp.fitc.nsum", None)]
    monkeypatch.setattr(S, "recorded", lambda: spans)
    for name in NEW:
        assert reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(reader, monkeypatch, name):
    """A program without the recorder, one without device spans (an older
    ``lcgp_tpu_torch``), or a session that recorded none, reads None."""
    from lcgp_tpu_torch.utils import profiling
    ctx = _ctx()
    monkeypatch.setattr(profiling, "spans",
                        lambda: [_span(1, "lcgp.fit.eval", None)])
    assert reader(name)(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name)(ctx) is None
    assert reader(name)(SimpleNamespace(trace=None, window={})) is None


def test_the_cell_is_found_by_name():
    man = Manifest()
    cell = man.cell(CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "refit_k10"
    cfg = man.config(cell["config"])
    assert (cfg["n"], cfg["p"], cfg["d"]) == (400000, 20, 2)
    assert cfg["model"] == {"q": 4, "inducing": 512, "n_chunk": 0,
                            "precision": "fast", "kernel": "matern32"}
    assert cfg["fit"] == {"method": "scipy",
                          "reference_optimizer": "L-BFGS-B"}
    assert set(man.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap"}
    assert man.traffic(cell["traffic"])["kind"] == "refit"
    assert callable(man.kind("refit").numbers)
    e2e = {m["name"] for m in man.metrics(CELL, traced=False)}
    assert {"setup_s", "fit_iter_ms", "peak_mem_gib"} <= e2e
    traced = {m["name"] for m in man.metrics(CELL, traced=True)}
    assert set(NEW) | {"evals_per_iter.fit", "gram_roofline.fit",
                       "fit_step_mfu", "eval_ms.fit"} <= traced
    for name in traced | e2e:
        assert callable(man.reader(name))
    declared = {m["name"]: m for m in man.data["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "program_span", "fit_iter_ms", [CELL])
        assert m["layer"] == declared["eval_ms.fit"]["layer"]
