"""BENCHMARK.json against the benchmark contract's shape rules, the files
it names, and the harness's independence of the JAX package."""
import ast
import json
import re
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT, run_tiny, write_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert all(_line(w) for w in bench["command"])
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["reduced"] == []
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(bench["paths"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in bench[g]]
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reported(bench, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_is_reported_by_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reported(bench, e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"] if _reported(bench, m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(_reported(bench, m, w["name"]) for m in bench["per_layer"])


def test_every_named_file_is_there(bench):
    from hb.manifest import Manifest
    man = Manifest()
    for w in bench["workloads"]:
        kind = man.kind(man.traffic(w["traffic"])["kind"])
        assert all(callable(getattr(kind, f)) for f in (
            "setup", "window", "traced_window", "release", "numbers",
            "stand_in_numbers"))
        man.config(w["config"])
        man.limits(w["name"])
    for g in ("end_to_end", "per_layer"):
        for m in bench[g]:
            assert callable(man.reader(m["name"]))


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell added as a configuration file, a traffic file, a limits file
    and manifest entries runs through the unchanged harness."""
    from hb.manifest import Manifest
    root, bench_dir = write_bench(tmp_path, [("lf.fit_short", "lf", "k2")])
    (bench_dir / "traffic" / "k2.json").write_text(
        json.dumps({"kind": "refit", "maxiter": 2}))
    (bench_dir / "limits" / "lf.fit_short.json").write_text(
        json.dumps({"loss_gap": 1e-10, "grad_gap": 1e-8, "change_gap": 1e-8}))
    man = Manifest(root, bench_dir)
    ctx, line = run_tiny(man, "lf.fit_short", seconds=0.5)
    assert line["correct"]
    assert {"setup_s", "fit_iter_ms"} <= set(line["metrics"])
    assert all(f["nit"] <= 2 for f in ctx.window["fits"])


def test_seeded_traffic_repeats():
    import numpy as np

    from hb.manifest import Manifest
    serve = Manifest().kind("open_loop")
    t = {"rate_per_s": 300, "size_min": 1, "size_max": 256,
         "check_requests": 48}
    a = serve.schedule(t, 4.0, 3000000019, 8)
    b = serve.schedule(t, 4.0, 3000000019, 8)
    c = serve.schedule(t, 4.0, 3000000020, 8)
    for k in ("offs", "sizes", "x"):
        assert np.array_equal(a[k], b[k])
    assert a["keep"] == b["keep"]
    # another seed: the same sizes and gaps, in another order
    assert not np.array_equal(a["sizes"], c["sizes"])
    assert np.array_equal(np.sort(a["sizes"]), np.sort(c["sizes"]))
    assert np.allclose(np.sort(np.diff(a["offs"], prepend=0.0)),
                       np.sort(np.diff(c["offs"], prepend=0.0)))
    assert a["sizes"].min() >= 1 and a["sizes"].max() <= 256


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _code_strings(path):
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_jax_and_no_reads_of_the_old_benchmarks():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "lcgp_tpu"), (p, mod)
            if "reference" in p.parts:
                assert top != "lcgp_tpu_torch", (p, mod)
        for s in _code_strings(p):
            assert not any(w in s for w in ("benchmarks/", "bench.py",
                                            "chip_smoke")), (p, s)


def test_refuses_without_a_card(tmp_path):
    """No CUDA card here: the run exits non-zero and prints no result, from
    the repository and from a directory holding only the benchmark."""
    import shutil
    cmd = [sys.executable, "h100_bench/run.py", "--workload",
           "large_field.fit", "--seed", "3000000123", "--seconds", "1",
           "--trace", "0"]
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "h100_bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
