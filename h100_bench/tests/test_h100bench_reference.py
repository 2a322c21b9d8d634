"""The plain reference agrees with lcgp_tpu_torch at a tiny size on the
CPU: the init, the inducing points, the exact and FITC losses with their
gradients, and the exact and FITC predictions.  (The test imports both; the
reference itself imports nothing of the port.)"""
import pytest
import torch
from conftest import TINY_CONFIGS

from reference import data as D
from reference import lcgp_ref as R


def _model(cfg, x, y):
    from lcgp_tpu_torch import LCGP
    return LCGP(y=y, x=x, device="cpu",
                **{**cfg["model"], "precision": "high"})


@pytest.mark.parametrize("name", ["lf", "fc"])
def test_reference_matches_the_port(name):
    from lcgp_tpu_torch.models.params import FreeParams
    cfg = TINY_CONFIGS[name]
    x, y = D.make(cfg, 3000000321, "cpu")
    model = _model(cfg, x, y)
    prob = R.prepare(x, y, cfg["model"]["q"])
    th0 = R.init_free(prob)
    for k, t in zip(R.LEAVES, model.free):
        assert torch.allclose(th0[k], t, rtol=1e-13, atol=1e-13), k
    z = None
    if "inducing" in cfg["model"]:
        z = torch.as_tensor(R.select_inducing(prob.xs.numpy(),
                                              cfg["model"]["inducing"]))
        assert torch.equal(z, model._z)
    leaves = [t.clone().requires_grad_(True) for t in model.free]
    model.free = FreeParams(*leaves)
    loss = model.loss()
    loss.backward()
    ref, g = (R.fitc_loss(th0, prob, z, grad=True) if z is not None
              else R.exact_loss(th0, prob, grad=True))
    assert abs(float(loss) - ref) <= 1e-12 * abs(ref)
    for k, t in zip(R.LEAVES, leaves):
        scale = float(g[k].abs().max())
        assert float((t.grad - g[k]).abs().max()) <= 1e-11 * scale, k
    x0 = D.inputs(23, cfg["d"], D.generator(5, "cpu"), "cpu")
    got = _model(cfg, x, y).predict(x0)
    want = (R.fitc_predict(th0, prob, z, x0) if z is not None
            else R.exact_predict(th0, prob, x0))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_data_repeats_by_seed():
    cfg = TINY_CONFIGS["lf"]
    a = D.make(cfg, 2 ** 40 + 17, "cpu")
    b = D.make(cfg, 2 ** 40 + 17, "cpu")
    c = D.make(cfg, 2 ** 40 + 18, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # another seed: the same rows in another order
    assert not torch.equal(a[0], c[0])
    order = torch.argsort(a[0][:, 0])
    back = torch.argsort(c[0][:, 0])
    assert torch.equal(a[0][order], c[0][back])
    assert torch.equal(a[1][:, order], c[1][:, back])
