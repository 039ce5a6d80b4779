"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: the program's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH = harness.ROOT / "portbench"


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (relative imports
    stay inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_whole_name_comparison():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "optax", "imagegeneration_tpu")
    found = {m.split(".")[0] for m in ("imagegeneration_tpu_torch.ops", "jaxtyping",
                                       "jax.numpy", "flaxen")} & set(harness.FORBIDDEN)
    assert found == {"jax"}


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & set(harness.FORBIDDEN)
        assert not bad, (f, bad)


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert {f.name for f in files} >= {"common.py", "hash.py", "sndcgan.py", "cyclegan.py"}
    for f in files:
        imported = _imports(f)
        assert harness.PROGRAM not in imported, f
        assert imported <= {"__future__", "contextlib", "math", "torch", "portbench"}, (f, imported)


RUN = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.small import SmallSpec
for cell in ("sndcgan-b128", "cyclegan-b4"):
    assert harness.run(cell, 1, 0.1, False, spec=SmallSpec(), device="cpu")["attempted"] >= 1
print(",".join(harness.forbidden_modules()) or "none")
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", RUN.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"
