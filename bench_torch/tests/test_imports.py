"""Nothing the benchmark runs imports JAX, the JAX package, the repo's
older benchmark scripts or anything of the program but its package."""

import ast
import subprocess
import sys

from bench_torch.harness import manifest

FORBIDDEN = ("jax", "jaxlib", "mathmap_tpu", "chip_smoke", "chip_profile", "benchmarks", "bench")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_import_in_any_file():
    files = sorted(manifest.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from bench_torch.harness import manifest, cell\n"
        "c = manifest.find_cell(manifest.load_benchmark(), 'distort.frames_1080p')\n"
        "cell.run(c, 3, 0.2, False, torch.device('cpu'), time.perf_counter(),\n"
        "         {'width': 32, 'height': 18, 'pool': 6, 'sample_per_filter': 1})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print('BAD', bad)\n" % (str(manifest.ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout
