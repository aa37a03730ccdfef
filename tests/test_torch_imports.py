"""The PyTorch port and chip_smoke.py stand alone: they import no JAX, flax,
optax, orbax or JAX-package module (the machine with the card has none of
them; the port's checkpoints are torch files), and importing the port pulls
in none of them either. pyarrow, transformers, sqlalchemy, psycopg and
tensorflow, which the card machine lacks too, are imported only inside the
functions that need them (parquet IO, the HF text embedder, the SQL shim
and write-back): no module imports one at its top level, and importing
every module and chip_smoke.py loads none of them. Every module of the
package is scanned, the trainer, checkpoints, ETL and CLIs included."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "jodalrob_twotower_tpu"}
IMPORTED_IN_FUNCTIONS_ONLY = {"pyarrow", "transformers", "sqlalchemy", "psycopg", "tensorflow"}
SOURCES = sorted((REPO / "jodalrob_twotower_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path, *, top_level_only: bool = False) -> set[str]:
    """The root packages ``path`` imports: anywhere, or outside every function."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if top_level_only:
        def outside_functions(node):
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    yield from outside_functions(child)

        nodes = outside_functions(tree)
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & FORBIDDEN
    assert not _imported_roots(path, top_level_only=True) & IMPORTED_IN_FUNCTIONS_ONLY


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES
        if p.name != "chip_smoke.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | IMPORTED_IN_FUNCTIONS_ONLY)!r})\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr


PARALLEL = sorted((REPO / "jodalrob_twotower_torch" / "parallel").glob("*.py"))
MESH_WORKERS = REPO / "tests" / "torch_mesh_workers.py"


@pytest.mark.parametrize("path", PARALLEL + [MESH_WORKERS], ids=lambda p: str(p.relative_to(REPO)))
def test_the_mesh_and_its_test_ranks_import_nothing_of_jax(path):
    """The mesh (``parallel/``) is scanned like every module; the module whose
    functions the mesh tests run in spawned ranks imports no JAX either, nor
    tests/torch_parity.py, which does."""
    assert {"mesh.py", "distributed.py", "sharded_embedding.py", "sharded_train.py", "sharded_store.py",
            "sharded_sparse.py"} <= {p.name for p in PARALLEL}
    assert path in SOURCES or path == MESH_WORKERS
    assert not _imported_roots(path) & (FORBIDDEN | {"torch_parity"})
