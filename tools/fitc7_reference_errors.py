#!/usr/bin/env python3
"""lcgp_tpu's own 'fast' FITC error on config 7's field, on the CPU: the
yardstick that ``chip_smoke.FITC7_FAST_BOUNDS`` and the 'fast' FITC tests
hold the port to (4x this error).

    PYTHONPATH=. python tools/fitc7_reference_errors.py 100000

Config 7 is ``benchmarks/run_configs.py``'s (d=2, p=20, q=4, m=512); the
first n rows of its field, its inducing points as
``chip_smoke.fitc7_inputs`` chooses them (the farthest-point rows of all
400,000) and its 64-point request.  At the init, lcgp_tpu's un-chunked
'fast' model against its f64 model (streamed, n_chunk 4096: the same as
un-chunked to ~1e-12): the loss (relative), each gradient leaf (of its
max |g|) and ypred, ypredvar and yconfvar (of the largest entry).

Each part runs in a process of its own, so that none holds more than one
component's un-chunked panels: the f64 loss and gradient; each
component's 'fast' loss and gradient alone (one column of phi and D, that
component's kernel parameters: the batched loss's f32 work for it); the
terms without the Gram, which every component's loss carries once; the
f64 predictions; the 'fast' predictions.  A part peaks at ~4.5 GB at
n=100,000 and ~38 KB more a row.  Imports JAX and lcgp_tpu: it measures
the reference, not the port.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LEAVES = ('lLmb', 'lLmb0', 'lsigma2s', 'lnugGPs')
OUTPUTS = ('ypred', 'ypredvar', 'yconfvar')


def field(n):
    """(x, y, x0, z): the first n rows of config 7's field, its 64-point
    request and config 7's inducing points in x's units."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import fitc7_inputs
    x, y, x0, z = fitc7_inputs()
    return x[:n], y[:, :n], x0, z


def part(n, which):
    """One part (see the module's docstring) as a JSON-able dict."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import lcgp_tpu
    from lcgp_tpu.models import params as JP
    from lcgp_tpu.models import sparse as JS
    x, y, x0, z = field(n)
    if which.startswith('pred_'):
        kw = (dict(n_chunk=4096) if which == 'pred_f64'
              else dict(n_chunk=0, precision='fast'))
        m = lcgp_tpu.LCGP(y, x, q=4, inducing=z, **kw)
        return dict(pred=[np.asarray(a, dtype=np.float64).tolist()
                          for a in m.predict(x0)])
    if which == 'f64':
        m = lcgp_tpu.LCGP(y, x, q=4, inducing=z, n_chunk=4096)
        v, g = jax.value_and_grad(lambda f: JS.neglpost_full_fitc(
            f, m._data, m._z, kernel=m.kernel, n_chunk=4096))(m._free)
    else:
        m = lcgp_tpu.LCGP(y, x, q=4, inducing=z, n_chunk=0,
                          precision='fast')
        free, data = m._free, m._data
        if which == 'shared':
            def fn(f):
                lsig = JP.expand_sigma(JP.constrain(f)[2], data.sigma_map)
                return (0.5 * data.xs.shape[0] * jnp.sum(lsig)
                        + 0.5 * jnp.sum(jnp.square(
                            data.ys / jnp.sqrt(jnp.exp(lsig))[:, None])))
            v, g = jax.value_and_grad(fn)(free)
        else:
            k = int(which)
            f_k = JP.FreeParams(free[0][k:k + 1], free[1][k:k + 1], free[2],
                                free[3][k:k + 1])
            d_k = data._replace(phi=data.phi[:, k:k + 1],
                                diag_D=data.diag_D[k:k + 1])
            v, g = jax.value_and_grad(lambda f: JS.neglpost_full_fitc(
                f, d_k, m._z, compute_dtype=m._compute_dtype,
                kernel=m.kernel, n_chunk=None))(f_k)
    return dict(loss=float(v),
                grads=[np.asarray(a, dtype=np.float64).tolist() for a in g])


def errors(n):
    """lcgp_tpu's 'fast' loss, gradient leaves and 64-point outputs against
    its f64 at n rows of config 7's field: {name: error}."""
    def run(which):
        out = subprocess.run([sys.executable, __file__, str(n), '--part',
                              which], capture_output=True, text=True,
                             check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])
    ref, shared = run('f64'), run('shared')
    q = 4
    value = -(q - 1) * shared['loss']
    grads = [np.zeros(np.shape(a)) for a in ref['grads']]
    grads[2] -= (q - 1) * np.asarray(shared['grads'][2])
    for k in range(q):
        got = run(str(k))
        value += got['loss']
        for i in (0, 1, 3):
            grads[i][k] = np.asarray(got['grads'][i])[0]
        grads[2] += np.asarray(got['grads'][2])
    out = dict(loss=abs(value - ref['loss']) / abs(ref['loss']))
    for nm, a, b in zip(LEAVES, grads, ref['grads']):
        b = np.asarray(b)
        out[nm] = float(np.abs(a - b).max() / np.abs(b).max())
    p64, p32 = run('pred_f64')['pred'], run('pred_fast')['pred']
    for nm, a, b in zip(OUTPUTS, p32, p64):
        a, b = np.asarray(a), np.asarray(b)
        out[nm] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


if __name__ == '__main__':
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    if '--part' in sys.argv:
        print(json.dumps(part(n, sys.argv[sys.argv.index('--part') + 1])))
    else:
        for k, v in errors(n).items():
            print(f'{k}: {v:.4e}', flush=True)
