"""Shared fixtures of the benchmark's own tests: the harness's folders on
the import path, and a tiny benchmark of the same kinds of cell, built in a
temporary directory, that runs on the CPU in seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

TINY_CONFIGS = {
    "lf": {"name": "lf", "field": "large_field", "n": 96, "p": 30, "d": 3,
           "noise": 0.05, "data_seed": 0,
           "model": {"q": 4, "q_chunk": 2, "precision": "high",
                     "kernel": "matern32"},
           "fit": {"method": "auto", "reference_optimizer": "L-BFGS-B"},
           "serve": {"batch": 32, "params": "init"}, "reduced": []},
    "fc": {"name": "fc", "field": "fitc_field", "n": 600, "p": 6, "d": 2,
           "noise": 0.05, "data_seed": 13,
           "model": {"q": 2, "inducing": 24, "n_chunk": 0,
                     "precision": "fast", "kernel": "matern32"},
           "serve": {"batch": 32, "params": "init"}, "reduced": []},
}
TINY_TRAFFIC = {
    "refit": {"kind": "refit", "maxiter": 5},
    "ol": {"kind": "open_loop", "rate_per_s": 60, "size_min": 1,
           "size_max": 40, "threads": 4, "check_requests": 8,
           "trace_seconds": 1, "close_wait_s": 30, "batch_seconds": 0.3},
}
# the tiny cells' limits: above what sound runs read on the CPU (float64
# ~1e-15, 'fast' float32 ~1e-5) and far below what the planted faults read
TINY_LIMITS = {
    "lf.fit": {"loss_gap": 1e-10, "grad_gap": 1e-8, "change_gap": 1e-8},
    "lf.serve": {"mean_gap": 1e-10, "var_gap": 1e-10},
    "fc.serve": {"mean_gap": 1e-3, "var_gap": 1e-3},
}


def write_bench(root: Path, extra_cells=()):
    """A benchmark directory of the tiny cells under ``root``, with the real
    metric readers; returns (root, bench_dir)."""
    bench = root / "h100_bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "kinds"):
        shutil.copytree(BENCH / sub, bench / sub, dirs_exist_ok=True)
    for name, cfg in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, lim in TINY_LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps(lim))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [("lf.fit", "lf", "refit"), ("lf.serve", "lf", "ol"),
             ("fc.serve", "fc", "ol"),
             *extra_cells]
    man = dict(real)
    man["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                       "file": f"h100_bench/configs/{n}.json", "why": "tiny"}
                      for n in TINY_CONFIGS]
    man["workloads"] = [{"name": c, "config": cf, "traffic": t, "chips": 1,
                         "why": "tiny"} for c, cf, t in cells]
    fits = [c for c, _, _ in cells if c.split(".")[1].startswith("fit")]
    serves = [c for c, _, _ in cells if c not in fits]
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            if "workloads" in m:
                m["workloads"] = (fits if m["workloads"][0].endswith(".fit")
                                  else serves)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    from hb.manifest import Manifest
    root, bench = write_bench(tmp_path)
    return Manifest(root, bench)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def run_tiny(man, cell, seed=3000000007, seconds=1.5):
    """One untraced run of a tiny cell on the CPU: (context, result line)."""
    import time

    from hb import runner
    ctx = runner.context(man, cell, seed, seconds, False, "cpu",
                         time.perf_counter())
    runner.measure(ctx)
    return ctx, runner.result(man, ctx, 1)

