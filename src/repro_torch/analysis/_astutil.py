"""Shared AST plumbing for the analysis passes: import-alias resolution and
dotted-name extraction, so rules can match `repro_torch.prng.normal` whether
it was spelled that way or via `import repro_torch.prng as jr` /
`from repro_torch import prng`.  A copy of the JAX package's module: the
port imports nothing of that package.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c"; None for anything that is not a pure name chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def collect_import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> canonical dotted module/attribute path.

    `import repro_torch.prng as jr` -> {"jr": "repro_torch.prng"}
    `from repro_torch import prng`  -> {"prng": "repro_torch.prng"}
    `from repro_torch.prng import normal as nrm`
                                    -> {"nrm": "repro_torch.prng.normal"}
    `import torch`                  -> {"torch": "torch"}
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def canonical(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted path of a name chain with import aliases expanded."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in aliases:
        return aliases[head] + ("." + rest if rest else "")
    return name


def walk_functions(tree: ast.Module
                   ) -> Iterator[Tuple[str, ast.AST]]:
    """(qualname, FunctionDef/AsyncFunctionDef) for every function, with
    class nesting reflected in the qualname ("Class.method")."""
    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)
    yield from visit(tree, "")


def call_roots(expr: ast.AST, aliases: Dict[str, str]) -> Iterator[str]:
    """Canonical dotted paths of every Call's callee inside `expr`."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            path = canonical(node.func, aliases)
            if path is not None:
                yield path
