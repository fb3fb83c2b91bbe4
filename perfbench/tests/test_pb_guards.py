"""What the harness may load, how it finds its pieces, when it refuses to
run, and the shape of its result line."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run, spec

from .conftest import small_cell

PB = Path(spec.__file__).resolve().parent
ROOT = PB.parent


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return [p for p in (PB / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not _imports(p) & run.FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_port():
    for p in _sources("reference") + [PB / "data.py"]:
        assert not any(n.startswith("multigridbarrier") for n in _imports(p)), p
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.check, "
            "perfbench.reference.solve, perfbench.data; "
            "print(sorted(m for m in sys.modules if m.startswith('multigridbarrier')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax():
    """A whole run on the CPU (the harness's look for a card skipped) loads
    the port and never jax, jaxlib, flax or multigridbarrier_tpu, compared
    by whole top-level names."""
    code = ("import sys; sys.path.insert(0, %r); from perfbench import run; "
            "from perfbench.tests.conftest import small_cell; "
            "run.measure(small_cell(L=3), 5, 0.1, trace=True, device='cpu'); "
            "print(run.forbidden_loaded(), 'multigridbarrier_tpu_torch' in sys.modules)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
    assert run.forbidden_loaded.__doc__ and "multigridbarrier_tpu" in run.FORBIDDEN
    sys.modules.setdefault("multigridbarrier_tpu_torch_lookalike", None)
    assert "multigridbarrier_tpu_torch_lookalike" not in run.forbidden_loaded()


def _digest(d):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in d.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_pieces_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    before = _digest(root)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "fem2d_L7_p1_f64.json").read_text())
    (pb / "configs" / "fem2d_L5.json").write_text(json.dumps(dict(cfg, L=5)))
    (pb / "traffic" / "dense.json").write_text(json.dumps(
        dict(json.loads((pb / "traffic" / "nd.json").read_text()),
             route={"dense_threshold": 1 << 30}, check={"decrement": 1.0})))
    (pb / "metrics" / "solves.py").write_text("def read(rec):\n    return len(rec.solves)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="fem2d_L5",
                                 file="perfbench/configs/fem2d_L5.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="fem2d_L5.dense",
                                   config="fem2d_L5", traffic="dense"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="solves",
                                   workloads=["fem2d_L5.dense"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(root, "fem2d_L5.dense", pb)
    assert cell.config["L"] == 5 and cell.traffic["route"] == {"dense_threshold": 1 << 30}
    assert cell.limits()["decrement"] == 1.0 and cell.limits()["obj_rel"] == cfg["check"]["obj_rel"]
    assert "solves" in [m["name"] for m in cell.per_layer]
    assert "solves" not in [m["name"] for m in spec.load_cell(root, "fem2d_L7.nd", pb).per_layer]
    assert spec.reader("solves", pb)(type("R", (), {"solves": [1, 2]})) == 2
    after = _digest(root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [Path("BENCHMARK.json")]


def test_the_timed_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "fem2d_L7.nd",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CPU" in out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    cell = small_cell()
    out = run.measure(cell, 11, 0.1, trace=bool(trace), device="cpu")
    line = run.result_line(cell, out, bool(trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] >= 1
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    assert set(line["metrics"]) <= set(names)
    if trace:
        assert {"nd_direction_ms", "newton_its", "geometry_s"} <= set(line["metrics"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the profiled solve's data solved again without the profiler: the spans' run
        first, again = out["rec"].solves[:2]
        assert again["data"] == first["data"] and again["its"] == first["its"]
        assert out["rec"].base_wall_s == again["wall"]
    else:
        assert set(line["metrics"]) == {"solve_s", "setup_s"}
    # each timed solve's logs, as host values, for readers of their own
    s = out["rec"].solves[0]
    assert sum(s["sol_main"]["its"]) == s["its"] and len(s["log"]) == s["its"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)
