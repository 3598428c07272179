"""No module of the benchmark imports JAX, the JAX package, ``bench`` or
``chip_smoke`` (top-level names compared whole: the port's name begins with
the JAX package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kubebrain_tpu", "bench", "chip_smoke"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, absolute imports
    only (a relative import stays inside ``kbbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not imported(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "dataset.py", "roofline.py"):
        assert "kubebrain_tpu_torch" not in imported(BENCH / name)


def test_the_walk_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import kubebrain_tpu.ops.scan\nfrom jax import numpy\n")
    assert imported(bad) & FORBIDDEN == {"kubebrain_tpu", "jax"}
    ok = tmp_path / "ok.py"
    ok.write_text("import kubebrain_tpu_torch.cli\n")
    assert not imported(ok) & FORBIDDEN
