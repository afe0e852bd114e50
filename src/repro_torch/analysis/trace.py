"""Host-sync hygiene pass (AST): device-to-host syncs and shared state
inside the port's hot paths.

The JAX package's trace-hygiene pass guards jitted code against retraces
and host syncs.  The port runs eagerly: nothing is traced, and every op is
a launch that the host queues ahead of the card.  What stalls that queue is
a device-to-host sync: the host waits for every launch before it, and the
card then idles while the host catches up.  The port's hot paths are
host-bound already (an LM decode step is mostly host time; host scoring is
most of a detector sweep), so one sync in them costs end to end.

Roots are DECLARED, not discovered: `HOT_PATH_ROOTS` in
`repro_torch.analysis.registry` names, per file, the port's twin of each of
the JAX package's jit roots, plus the kernel wrappers every die draw goes
through.  Reachability within a module is transitive (same-module calls);
a cross-module edge is a root of its own.  Inside the reachable set:

  TRC101  Python `if`/`while` whose condition calls a `torch.*` op that
          returns a tensor: the condition is an implicit `bool(tensor)`,
          which on the card syncs the device to the host.  The calls that
          return plain Python values are allowed (`NON_TENSOR_CALLS`).
  TRC102  explicit host syncs: `.item()`, `.tolist()`, `.cpu()`,
          `.numpy()`, `float()`/`int()`/`bool()` over a torch expression,
          `np.asarray`/`np.array` (on a tensor they pull it to the host),
          and `torch.cuda.synchronize()` or an event's or stream's
          `.synchronize()`.
  TRC103  op-boundary signature bugs: a `torch.library.custom_op(...,
          mutates_args=...)` naming a parameter the function lacks (the
          dispatcher then treats the written argument as read-only, and a
          functionalized or fake run silently drops the write), and mutable
          default values (list/dict/set) on hot-path functions (one object
          shared by every call).  The JAX package's `static_argnames`
          check has no eager counterpart; `mutates_args` is the port's op
          boundary in its place.  Every custom op in a file is checked,
          reachable or not, as every jitted function is in the JAX package.
  TRC104  a hot-path function reads a module-level mutable literal
          (dict/list/set).  Nothing is baked in at trace time here; the
          hazard is that such a global is shared by every thread of the
          process — the sweep's host thread and the detector service's
          scheduler thread both run these paths — so a result that
          depends on it changes with call order.  A counter is not a
          read: a global whose only use in the function is as the target
          of an augmented assignment (`LAUNCHES[name] += 1`, the launch
          counters) is updated, never read for a result, and is not
          flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis._astutil import (canonical, collect_import_aliases,
                                           dotted_name, walk_functions)
from repro_torch.analysis.findings import Finding

# `torch.*` calls that return plain Python values (or objects that are not
# tensors): a condition on them is decided on the host without a sync.
NON_TENSOR_CALLS = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.broadcast_shapes", "torch.Size", "torch.device", "torch.dtype",
    "torch.finfo", "torch.iinfo", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.get_default_dtype", "torch.get_default_device",
    "torch.get_float32_matmul_precision",
    "torch.are_deterministic_algorithms_enabled",
    "torch._C._len_torch_dispatch_stack",
})
# whole namespaces of host-side queries (device counts and names, backend
# flags, the dispatcher, the distributed group's sizes and ranks)
NON_TENSOR_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.library.",
                       "torch.distributed.", "torch.compiler.", "torch.jit.",
                       "torch._C.", "torch.utils.")
CUSTOM_OP = "torch.library.custom_op"
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def _tensor_call(path: Optional[str]) -> bool:
    return bool(path) and path.startswith("torch.") \
        and path not in NON_TENSOR_CALLS \
        and not path.startswith(NON_TENSOR_PREFIXES)


def _is_torch_rooted(expr: ast.AST, aliases) -> bool:
    """True when `expr` calls a `torch.*` op that returns a tensor."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) \
                and _tensor_call(canonical(node.func, aliases)):
            return True
    return False


class TraceHygienePass:
    def __init__(self, path: str, source: str,
                 extra_roots: Optional[Set[str]] = None):
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.aliases = collect_import_aliases(self.tree)
        self.extra_roots = extra_roots or set()
        self.findings: List[Finding] = []
        self.functions: Dict[str, ast.AST] = dict(walk_functions(self.tree))

    # -------------------------------------------------------- reachability
    def _custom_op_kwargs(self, fn) -> Optional[List[ast.keyword]]:
        """The keywords of `fn`'s `torch.library.custom_op(...)` decorator;
        None when it has none."""
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) \
                    and canonical(dec.func, self.aliases) == CUSTOM_OP:
                return dec.keywords
        return None

    def _roots(self) -> Set[str]:
        return {r for r in self.extra_roots if r in self.functions}

    def _local_callees(self, qualname: str) -> Set[str]:
        fn = self.functions[qualname]
        cls_prefix = qualname.rsplit(".", 1)[0] + "." if "." in qualname \
            else ""
        out = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if name in self.functions:
                out.add(name)
            elif name.startswith("self.") and cls_prefix:
                m = cls_prefix + name[len("self."):]
                if m in self.functions:
                    out.add(m)
        return out

    def reachable(self) -> Set[str]:
        seen: Set[str] = set()
        stack = list(self._roots())
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(self._local_callees(q) - seen)
        return seen

    # -------------------------------------------------------------- rules
    def _check_body(self, qualname: str, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)) \
                    and _is_torch_rooted(node.test, self.aliases):
                kw = "while" if isinstance(node, ast.While) else "if"
                self.findings.append(Finding(
                    rule="TRC101", file=self.path, line=node.lineno,
                    message=f"Python `{kw}` on a torch tensor in hot-path "
                            f"`{qualname}` syncs the device to the host",
                    hint="use torch.where / a masked op, or decide on a "
                         "host-side value (a shape, a config field)"))
            elif isinstance(node, ast.Call):
                self._check_host_sync(qualname, node)

    def _check_host_sync(self, qualname: str, call: ast.Call) -> None:
        path = canonical(call.func, self.aliases)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in SYNC_METHODS and not call.args \
                and not call.keywords:
            self.findings.append(Finding(
                rule="TRC102", file=self.path, line=call.lineno,
                message=f".{call.func.attr}() host sync in hot-path "
                        f"`{qualname}`",
                hint="keep values on the device; sync once, outside the "
                     "hot path, where the host needs the value"))
        elif path in ("float", "int", "bool") and call.args \
                and _is_torch_rooted(call.args[0], self.aliases):
            self.findings.append(Finding(
                rule="TRC102", file=self.path, line=call.lineno,
                message=f"{path}() over a torch expression in hot-path "
                        f"`{qualname}` forces a host sync",
                hint="stay in tensors on the hot path"))
        elif path in ("numpy.asarray", "numpy.array"):
            self.findings.append(Finding(
                rule="TRC102", file=self.path, line=call.lineno,
                message=f"numpy conversion in hot-path `{qualname}` "
                        f"pulls the value to the host",
                hint="use torch.as_tensor on the device, or move the "
                     "conversion out of the hot path"))

    def _check_op_boundary(self, qualname: str, fn: ast.AST) -> None:
        params = [a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                                  *fn.args.kwonlyargs)]
        for kw in self._custom_op_kwargs(fn) or []:
            if kw.arg != "mutates_args":
                continue
            v = kw.value
            names = [e.value for e in getattr(v, "elts", [])
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            for n in names:
                if n not in params:
                    self.findings.append(Finding(
                        rule="TRC103", file=self.path, line=fn.lineno,
                        message=f"mutates_args of custom op `{qualname}` "
                                f"names `{n}` which is not a parameter — "
                                f"the write is invisible to the "
                                f"dispatcher",
                        hint="match mutates_args to the signature"))

    def _check_defaults(self, qualname: str, fn: ast.AST) -> None:
        for default in (*fn.args.defaults, *fn.args.kw_defaults):
            if isinstance(default, (ast.Dict, ast.List, ast.Set)):
                self.findings.append(Finding(
                    rule="TRC103", file=self.path, line=default.lineno,
                    message=f"mutable default argument on hot-path "
                            f"`{qualname}`",
                    hint="default to None and build inside, or use a "
                         "frozen/hashable value"))

    def _mutable_globals(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                    and isinstance(stmt.value, (ast.Dict, ast.List, ast.Set,
                                                ast.ListComp, ast.DictComp,
                                                ast.SetComp)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = stmt.lineno
        return out

    def _check_global_capture(self, qualname: str, fn: ast.AST,
                              mutables: Dict[str, int]) -> None:
        local: Set[str] = {a.arg for a in (*fn.args.posonlyargs,
                                           *fn.args.args,
                                           *fn.args.kwonlyargs)}
        counted: Set[int] = set()     # ids of Name nodes a counter updates
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        local.add(t.id)
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Subscript) \
                    and isinstance(node.target.value, ast.Name):
                counted.add(id(node.target.value))
        reported: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in mutables and node.id not in local \
                    and node.id not in reported and id(node) not in counted:
                reported.add(node.id)
                self.findings.append(Finding(
                    rule="TRC104", file=self.path, line=node.lineno,
                    message=f"hot-path `{qualname}` reads module-level "
                            f"mutable `{node.id}`: every thread of the "
                            f"process shares it, so the result depends on "
                            f"call order",
                    hint="pass it as an argument, or freeze it into a "
                         "tuple/immutable constant"))

    # ----------------------------------------------------------------- run
    def run(self) -> List[Finding]:
        reach = self.reachable()
        mutables = self._mutable_globals()
        for qualname, fn in sorted(self.functions.items()):
            self._check_op_boundary(qualname, fn)
        for qualname in sorted(reach):
            fn = self.functions[qualname]
            self._check_body(qualname, fn)
            self._check_defaults(qualname, fn)
            self._check_global_capture(qualname, fn, mutables)
        return self.findings


def run_trace_pass(path: str, source: str,
                   extra_roots: Optional[Set[str]] = None) -> List[Finding]:
    return TraceHygienePass(path, source, extra_roots).run()
