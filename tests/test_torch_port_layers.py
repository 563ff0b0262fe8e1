"""The port's imports point down (ROADMAP.md, Constraints: the layers).

Every module of ``facegen_torch`` sits in one row, from the leaves (0) to
the entry points (9). A module imports only modules of its own row or a
lower one, at module level or inside a function; row 9 is the top, so
nothing below it imports an entry point; and the import graph has no
cycle, not even within one row. The graph is read with ``ast`` from the
source files, so nothing is imported and the tests take well under a
second. Two tests, not one per module: their count does not move when a
module is added or deleted.
"""

import ast
import fnmatch
import itertools
from pathlib import Path
from typing import Dict, List, Set

import torch_port_threads  # noqa: F401  (this xdist worker's share of the cores)

PACKAGE = Path(__file__).resolve().parent.parent / "facegen_torch"

# (row, patterns of module paths under facegen_torch/ without ".py"); the
# first pattern that matches places a module. A package's __init__ takes its
# package's row; the top package's and utils' hold only docstrings.
ROWS = (
    (0, ("__init__", "config", "ops/_build", "utils/__init__", "utils/profiling",
         "utils/grids")),
    (1, ("parallel/*",)),
    (2, ("ops/*",)),
    (3, ("nn/*",)),
    (4, ("utils/checkpoint",)),
    (5, ("models/*",)),
    (6, ("data/*",)),
    (7, ("utils/infer", "utils/viz", "utils/netvis", "utils/viewer")),
    (9, ("sample", "train_c2f", "train_autoencoder", "train_denoiser", "export", "eval/*",
         "train/__main__")),
    (8, ("train/*",)),
)


def _row(module: str) -> int:
    for row, patterns in ROWS:
        if any(fnmatch.fnmatchcase(module, p) for p in patterns):
            return row
    raise AssertionError(f"facegen_torch/{module}.py has no row in the layer table")


def _target(dotted: str) -> str:
    """The module path of a dotted ``facegen_torch`` name: its file, or the
    package's __init__ for a directory."""
    rel = dotted.split(".")[1:]
    path = PACKAGE.joinpath(*rel)
    if path.is_dir():
        return "/".join(rel + ["__init__"])
    return "/".join(rel) if rel else "__init__"


def _is_module(dotted: str) -> bool:
    path = PACKAGE.joinpath(*dotted.split(".")[1:])
    return path.is_dir() or path.with_suffix(".py").is_file()


def _imports(module: str, tree: ast.AST) -> Set[str]:
    """The ``facegen_torch`` modules ``module`` imports, anywhere in its file."""
    package = module.split("/")[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ["facegen_torch"] + package[:len(package) - node.level + 1]
                base = ".".join(base + ([node.module] if node.module else []))
            else:
                base = node.module or ""
            # ``from pkg import name``: the submodule when ``name`` is one
            names = [f"{base}.{a.name}" if _is_module(f"{base}.{a.name}") else base
                     for a in node.names]
        else:
            continue
        out.update(_target(n) for n in names if n.split(".")[0] == "facegen_torch")
    out.discard(module)
    return out


def _graph() -> Dict[str, Set[str]]:
    graph = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        module = path.relative_to(PACKAGE).with_suffix("").as_posix()
        graph[module] = _imports(module, ast.parse(path.read_text(), str(path)))
    return graph


def _cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Every simple cycle of ``graph``, each once, from its least module."""
    cycles = []
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cycles.append(path)
                elif nxt > start and nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return cycles


def test_imports_point_down():
    graph = _graph()
    bad = [f"{m} (row {_row(m)}) imports {t} (row {_row(t)})"
           for m, targets in graph.items() for t in sorted(targets) if _row(t) > _row(m)]
    assert not bad, "imports that point up:\n" + "\n".join(bad)
    assert len(graph) > 50, f"only {len(graph)} modules read from {PACKAGE}"


def test_import_graph_has_no_cycle():
    cycles = _cycles(_graph())
    assert not cycles, "import cycles:\n" + "\n".join(
        " -> ".join(itertools.chain(c, c[:1])) for c in cycles)
