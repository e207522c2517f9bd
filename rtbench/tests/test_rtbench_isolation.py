"""Nothing under rtbench/ imports JAX or the JAX package, compared by the
whole top-level name (``tpurt_torch`` begins with ``tpurt``), and
rtbench/reference/ imports nothing of the program: by a scan of every
module's imports, and by importing the modules in a fresh interpreter in
which those names cannot be imported."""
import ast
import subprocess
import sys

import pytest

from tiny import REPO, RTBENCH

JAX_NAMES = {"jax", "jaxlib", "flax", "tpurt"}
PROGRAM = {"tpurt_torch"}


def _imports(path):
    """The top-level names every import statement of `path` names, with a
    relative import resolved to ``rtbench``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "rtbench" if node.level else node.module.split(".")[0]


def _sources(sub=""):
    return sorted((RTBENCH / sub).rglob("*.py"))


def test_scan_finds_no_jax():
    for path in _sources():
        bad = set(_imports(path)) & JAX_NAMES
        assert not bad, f"{path} imports {bad}"


def test_scan_reference_imports_no_program():
    for path in _sources("reference"):
        bad = set(_imports(path)) & (JAX_NAMES | PROGRAM)
        assert not bad, f"{path} imports {bad}"


BLOCKER = """
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
import importlib, importlib.util, pathlib
for mod in filter(None, sys.argv[3].split(",")):
    importlib.import_module(mod)
for path in sys.argv[4].split(",") if sys.argv[4] else []:
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = {m.split(".")[0] for m in sys.modules}
assert not loaded & BLOCKED, loaded & BLOCKED
print("ok")
"""


def _import_blocked(blocked, modules, files=()):
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER, ",".join(sorted(blocked)),
         str(REPO), ",".join(modules), ",".join(map(str, files))],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _module_names(sub):
    names = []
    for path in _sources(sub):
        if "tests" in path.parts:
            continue
        rel = path.relative_to(REPO).with_suffix("")
        names.append(".".join(rel.parts).replace(".__init__", ""))
    return names


def test_harness_imports_with_jax_blocked():
    _import_blocked(JAX_NAMES, _module_names("harness") + _module_names(
        "scenes") + _module_names("reference") + ["rtbench.run",
                                                   "rtbench.control"],
        _sources("metrics"))


def test_reference_imports_with_program_blocked():
    _import_blocked(JAX_NAMES | PROGRAM, _module_names("reference")
                    + _module_names("scenes"))


@pytest.mark.parametrize("workload", ["tiny.orbit"])
def test_a_run_loads_no_jax(tmp_path, workload):
    """A whole run of a cut-down cell on the CPU, JAX blocked."""
    code = f"""
import sys, time
sys.path.insert(0, {str(RTBENCH / 'tests')!r})
from tiny import make_root
from pathlib import Path
from rtbench.harness.cell import run
root, bench = make_root(Path({str(tmp_path)!r}))
res, _ = run({workload!r}, 3, 0.2, False, t_start=time.perf_counter(),
             device="cpu", root=root, bench=bench)
assert res["correct"]
"""
    blocker = BLOCKER.replace('import importlib, importlib.util, pathlib',
                              'exec(sys.argv[5])\nimport importlib, '
                              'importlib.util, pathlib')
    out = subprocess.run(
        [sys.executable, "-c", blocker, ",".join(sorted(JAX_NAMES)),
         str(REPO), "", "", code], capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
