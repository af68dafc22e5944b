"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``repro_torch`` begins with ``repro``)."""
import ast
import subprocess
import sys

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_of_the_benchmark_imports_them():
    for path in (ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_what_a_run_loads_holds_none_of_them():
    code = (
        "import sys; sys.argv = ['bench/run.py']\n"
        "import runpy; g = runpy.run_path('bench/run.py', run_name='x')\n"
        "from bench import cell\n"
        "import bench.run as run\n"
        "c = cell.find_cell('arctic-1l.chat')\n"
        "for m in c.per_layer: cell.metric_reader(m['name'])\n"
        "cell.reference_module(c.config)\n"
        "cell.model_config(c.config)\n"
        "import repro_torch.launch.serve, repro_torch.engine.engine\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not (top & FORBIDDEN), top & FORBIDDEN
    assert "repro_torch" in top


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "arctic-1l.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
