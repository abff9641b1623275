"""No run of the benchmark may hold JAX or the JAX package, and the plain
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from bench.lib import harness

BENCH = Path(__file__).resolve().parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = _top_level_imports(path)
    assert not found & {"repro_torch", "bench"}, found
    assert found <= {"__future__", "math", "torch", "scipy", "numpy"}, found


def test_module_check_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.index": 1, "reproduce": 1, "torch": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"repro": 1, "repro.index": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1})
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                               "repro", "repro.index"]


def test_a_run_holding_jax_prints_no_result(monkeypatch):
    """The harness ends a run that holds a forbidden module, after its window
    and before any result."""
    import time

    from bench.conftest import ROOT, TINY

    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda modules=None: ["jax"])
    man = harness.Manifest(ROOT)
    w = man.workload("audio.cp_mixk")
    config, traffic = man.config(w), man.traffic(w)
    config["dataset"].update(TINY["audio"])
    traffic.update(TINY["cp_search"])
    with pytest.raises(SystemExit, match="forbidden"):
        harness.run_cell("audio.cp_mixk", 1, 0.05, False, started=time.perf_counter(),
                         device="cpu", manifest=man, config=config, traffic=traffic)
