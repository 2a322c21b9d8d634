"""The check that decides ``correct``, driven through whole runs of the tiny
cells on the CPU (the look for a card skipped): sound runs pass; with the
timed path broken underneath, ``correct`` comes out false, once for each
fault the cells can have; and the control (the reference in the precision
below the configuration's, in the program's place) fails the limits."""
import numpy as np
import pytest
import torch
from conftest import run_tiny

from hb import check

FIT_CELLS = ["lf.fit"]
SERVE_CELLS = ["lf.serve", "fc.serve"]


@pytest.mark.parametrize("cell", FIT_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(tiny, cell):
    ctx, line = run_tiny(tiny, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


def _unchanged(monkeypatch):
    """Every fit returns its start unchanged."""
    from lcgp_tpu_torch.fit.adam import DeviceFitResult
    from lcgp_tpu_torch.models import lcgp

    def still(loss_fn, params0, callback=None, maxiter=10, **kw):
        for it in range(1, maxiter + 1):
            if callback is not None:
                callback(it, 0.0, params0)
        return DeviceFitResult(params=params0, fun=float(loss_fn(params0)),
                               nit=maxiter, nfev=maxiter)
    monkeypatch.setattr(lcgp, "minimize_lbfgs", still)
    monkeypatch.setattr(lcgp, "minimize_lbfgs_jax", still)


def _half_batch(monkeypatch):
    """The loss over the first half of the rows, scaled to the whole."""
    from lcgp_tpu_torch.models.lcgp import LCGP
    orig = LCGP._loss_fn

    def half(self, *a, **k):
        full = self._data
        h = full.xs.shape[0] // 2
        part = full._replace(xs=full.xs[:h], ys=full.ys[:, :h])
        self._data = part
        try:
            fn = orig(self, *a, **k)
        finally:
            self._data = full

        def loss(free):
            self._data = part
            try:
                return 2.0 * fn(free)
            finally:
                self._data = full
        return loss
    monkeypatch.setattr(LCGP, "_loss_fn", half)


def _fit_answer_altered(monkeypatch):
    """The loss is off by 1% where it is produced."""
    from lcgp_tpu_torch.models.lcgp import LCGP
    orig = LCGP._loss_fn

    def altered(self, *a, **k):
        fn = orig(self, *a, **k)
        return lambda free: 1.01 * fn(free)
    monkeypatch.setattr(LCGP, "_loss_fn", altered)


def _serve_step(monkeypatch, change):
    from lcgp_tpu_torch import serve as srv
    orig = srv._Fused.__call__

    def broken(self, x0):
        return change(orig(self, x0))
    monkeypatch.setattr(srv._Fused, "__call__", broken)


def _serve_half_batch(monkeypatch):
    """The second half of every dispatch's rows is left out."""
    def change(outs):
        for o in outs:
            o[:, o.shape[1] // 2:] = 0.0
        return outs
    _serve_step(monkeypatch, change)


def _serve_answer_altered(monkeypatch):
    """Each dispatch's first row's mean is off by 0.1."""
    def change(outs):
        outs[0][:, 0] += 0.1
        return outs
    _serve_step(monkeypatch, change)


FAULTS = [(c, f) for c in FIT_CELLS
          for f in (_unchanged, _half_batch, _fit_answer_altered)]
FAULTS += [(c, f) for c in SERVE_CELLS
           for f in (_serve_half_batch, _serve_answer_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    _, line = run_tiny(tiny, cell)
    assert not line["correct"], line["checks"]


def test_unchanged_state_reads_one():
    like = {k: torch.zeros(s) for k, s in
            zip(("lLmb", "lLmb0", "lsigma2s", "lnugGPs"), (6, 3, 4, 3))}
    ref = np.arange(1.0, 17.0)
    assert check.norm_gap(np.zeros(16), ref, like) == 1.0


def test_control_fails_the_float64_cells(tiny):
    """At float64 the control is the float32 reference: it reads far above
    the program and above every limit."""
    ctx, line = run_tiny(tiny, "lf.fit")
    ctl = ctx.kind.stand_in_numbers(ctx)
    for k, v in ctl["control"].items():
        assert v > line["checks"][k]["limit"], (k, v)
        assert v > 3 * line["checks"][k]["value"]
    for k, v in ctl["half_batch"].items():
        assert v > line["checks"][k]["limit"], (k, v)
    ctx, line = run_tiny(tiny, "lf.serve")
    ctl = ctx.kind.stand_in_numbers(ctx)["control"]
    assert any(v > line["checks"][k]["limit"] for k, v in ctl.items())
