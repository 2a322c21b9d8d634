"""Synthetic test functions used across docs, tests and benchmarks (a copy
of the JAX package's ``datasets.py``: it is pure NumPy, and importing it
from that package would import JAX through its ``__init__``).

Behavioral spec: reference docs/functions.py:4-42 and the 1-D replication
illustrations, illustration-examples/lcgp-rep-3d-illustration.py:13-103.
Every function returns NumPy arrays; with the same seed (or generator)
they equal the JAX package's exactly.
"""
from __future__ import annotations

import numpy as np


def cps2001(x, rng=None):
    """Cox, Parker & Singer (2001): 2 outputs, input-dependent noise.
    x (n, 4) -> y (n, 2)."""
    rng = np.random.default_rng() if rng is None else rng
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    x1, x2, x3, x4 = (x[:, i] for i in range(4))

    y11 = (x1 / 2) * (np.sqrt(1 + (x2 + x3 ** 2) * x4 / x1 ** 2) - 1)
    y12 = (x1 + 3 * x4) * np.exp(1 + np.sin(x3))
    y1 = y11 + y12
    y2 = (1 + np.sin(x1) / 10) * y1.copy() - 2 * x1 + x2 ** 2 + x3 ** 2 + 0.5

    noise_scale = 5 * x.mean(1) ** 2
    y1 = y1 + rng.normal(0, 1, x.shape[0]) * noise_scale
    y2 = y2 + rng.normal(0, 1, x.shape[0]) * noise_scale
    return np.column_stack((y1, y2))


def forrester2008(x, noisy=True, noises=(0.01, 0.1, 0.25), rng=None):
    """Forrester (2008) 1-D function fanned to 3 outputs with per-output
    noise variances.  x (n,) or (n,1) -> y (3, n)."""
    rng = np.random.default_rng() if rng is None else rng
    x = np.asarray(x, dtype=np.float64)
    x = x[:, None] if x.ndim < 2 else x

    y1 = (6 * x - 2) ** 2 * np.sin(12 * x - 4)

    def fan(y0, x0, a, b, c):
        return a * y0 + b * (x0 - 0.5) - c

    y2 = fan(y1, x, 0.5, 5, -5)
    y3 = fan(y1, x, -0.8, -5, 4)
    if noisy:
        y1 = y1 + rng.normal(0, np.sqrt(noises[0]), x.shape)
        y2 = y2 + rng.normal(0, np.sqrt(noises[1]), x.shape)
        y3 = y3 + rng.normal(0, np.sqrt(noises[2]), x.shape)
    return np.vstack((y1.T, y2.T, y3.T))


def f_true_1d(x):
    """Smooth 3-output truth used by the 1-D replication illustrations."""
    x = np.asarray(x, dtype=np.float64)
    f1 = 0.8 + 0.3 * np.sin(2 * np.pi * x) + 0.2 * x
    f2 = 0.3 + 0.5 * np.cos(2 * np.pi * x)
    f3 = -0.4 - (x - 0.5) ** 2 + 0.2 * np.sin(4 * np.pi * x)
    return np.vstack([f1, f2, f3])


def make_rep_data_1d(n_unique=12, rep_choices=(1, 2, 3, 4),
                     noise_std=(0.05, 0.08, 0.10), seed=None, n_test=400):
    """Uniform-ish replication design on [0,1] with 3 outputs."""
    rng = np.random.default_rng(seed)
    x_unique = np.linspace(0.0, 1.0, n_unique)
    r = rng.choice(rep_choices, size=n_unique, replace=True)

    xs, ys = [], []
    for i, xi in enumerate(x_unique):
        yi = f_true_1d([xi])[:, 0]
        for _ in range(int(r[i])):
            eps = rng.normal(0, noise_std, 3)
            xs.append([xi])
            ys.append(yi + eps)
    xtrain = np.array(xs)
    ytrain = np.array(ys).T
    xtest = np.linspace(0.0, 1.0, n_test)[:, None]
    ytrue = f_true_1d(xtest[:, 0])
    return xtrain, ytrain, xtest, ytrue


def make_rep_data_skewed(n_unique=40, heavy_region=(0.20, 0.45),
                         light_rep_choices=(1, 2),
                         heavy_rep_choices=(8, 12, 16, 20),
                         noise_std=(0.05, 0.08, 0.10), seed=None, n_test=400):
    """The BASELINE.md 'Case 2' skewed replication design."""
    rng = np.random.default_rng(seed)
    x_unique = np.linspace(0.0, 1.0, n_unique)
    xs, ys = [], []
    for xi in x_unique:
        heavy = heavy_region[0] <= xi <= heavy_region[1]
        rep = int(rng.choice(heavy_rep_choices if heavy else light_rep_choices))
        yi = f_true_1d([xi])[:, 0]
        for _ in range(rep):
            eps = rng.normal(0, noise_std, 3)
            xs.append([xi])
            ys.append(yi + eps)
    xtrain = np.array(xs)
    ytrain = np.array(ys).T
    xtest = np.linspace(0.0, 1.0, n_test)[:, None]
    ytrue = f_true_1d(xtest[:, 0])
    return xtrain, ytrain, xtest, ytrue


def make_rep_data_hotspots(n_unique=50,
                           hotspots=((0.15, 10, 15), (0.50, 18, 25),
                                     (0.80, 12, 20)),
                           base_rep_choices=(1,),
                           noise_std=(0.05, 0.08, 0.10), seed=None,
                           n_test=400):
    """Hot-spot replication design: a few heavily replicated locations
    (each hotspot is (center, min_rep, max_rep)), single observations
    elsewhere."""
    rng = np.random.default_rng(seed)
    x_unique = np.linspace(0.0, 1.0, n_unique)
    hot = {int(np.argmin(np.abs(x_unique - c))): (lo, hi)
           for c, lo, hi in hotspots}
    xs, ys = [], []
    for i, xi in enumerate(x_unique):
        if i in hot:
            lo, hi = hot[i]
            rep = int(rng.integers(lo, hi + 1))
        else:
            rep = int(rng.choice(base_rep_choices))
        yi = f_true_1d([xi])[:, 0]
        for _ in range(rep):
            eps = rng.normal(0, noise_std, 3)
            xs.append([xi])
            ys.append(yi + eps)
    xtrain = np.array(xs)
    ytrain = np.array(ys).T
    xtest = np.linspace(0.0, 1.0, n_test)[:, None]
    ytrue = f_true_1d(xtest[:, 0])
    return xtrain, ytrain, xtest, ytrue


def borehole(x):
    """Borehole function; x (n, 8) in [0,1]^8 scaled to physical ranges.
    Returns (n,) water-flow response."""
    x = np.asarray(x, dtype=np.float64)
    rw = 0.05 + x[:, 0] * (0.15 - 0.05)
    rr = 100.0 + x[:, 1] * (50000.0 - 100.0)
    Tu = 63070.0 + x[:, 2] * (115600.0 - 63070.0)
    Hu = 990.0 + x[:, 3] * (1110.0 - 990.0)
    Tl = 63.1 + x[:, 4] * (116.0 - 63.1)
    Hl = 700.0 + x[:, 5] * (820.0 - 700.0)
    L = 1120.0 + x[:, 6] * (1680.0 - 1120.0)
    Kw = 9855.0 + x[:, 7] * (12045.0 - 9855.0)

    num = 2 * np.pi * Tu * (Hu - Hl)
    den = np.log(rr / rw) * (1 + 2 * L * Tu / (np.log(rr / rw) * rw ** 2 * Kw)
                             + Tu / Tl)
    return num / den


def make_borehole_field(n=1000, p=100, seed=0, noise=0.01):
    """Borehole-style field emulation config (BASELINE.json config 3):
    n design points in [0,1]^8, p-dim output field built from shifted
    borehole evaluations."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 8))
    base = borehole(x)
    t = np.linspace(0, 1, p)[:, None]
    field = (np.outer(np.sin(2 * np.pi * t[:, 0]), base / base.std())
             + t * (base / base.std())[None, :] * 0.5)
    y = field + rng.normal(0, noise, field.shape)
    return x, y
