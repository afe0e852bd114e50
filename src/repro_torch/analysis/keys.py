"""Key-discipline pass (AST): PRNG-key reuse, nondeterministic key sources,
and fold_in lattice collisions, on the port's threefry keys
(`repro_torch.prng` and the wrappers `repro_torch.kernels.ops.threefry_*`
that launch its kernel).

The port's bit-identity guarantees (ensemble chip `c` == the single-chip
`fold_in(key, c)` path; an early-stopped sweep == the full run's prefix;
each service lane == the MC chunk forward at its request key) are all
statements about WHICH key reaches which sampler.  The port's key is a
plain int64 tensor [..., 2] and holds no state, so the discipline is the
JAX package's and so are the rules:

  KEY001  a key variable is consumed by two samplers without an
          intervening `split`/`fold_in` (including consumption inside a
          loop of a key created outside it — the classic
          same-noise-every-iteration bug).
  KEY002  a key is constructed from a nondeterministic source (wall clock,
          os.urandom, uuid, Python/NumPy global RNGs, id()/hash(), and
          torch's own global generator: `torch.seed`, `torch.rand`, ...):
          runs stop being reproducible from a recorded root key.
  KEY003  `fold_in` collision hazards: two call sites in one scope deriving
          the same subkey (same base, same constant salt), or an arithmetic
          salt lattice (e.g. `s * 10 + b`) whose multiplier is not in
          `DECLARED_FOLD_LATTICES` — undeclared lattices can silently
          collide when an index outgrows the multiplier.
  KEY004  a split result is stored into mutable object state
          (`self.key, sub = split(self.key)`): the key stream then advances
          with CALL ORDER, so draws depend on request arrival.

Passing a key to `split`/`fold_in` is a DERIVATION, not a consumption;
passing the same base key to many derivations is exactly the intended
discipline and is never flagged.  A `*_plain` twin and an `ops.threefry_*`
wrapper count as the function they compute.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis._astutil import (canonical, collect_import_aliases,
                                           dotted_name, walk_functions)
from repro_torch.analysis.findings import Finding

PRNG = "repro_torch.prng."
OPS = "repro_torch.kernels.ops."

# prng consumers: a key passed here is SPENT.
SAMPLERS = frozenset({
    "random_bits", "uniform", "normal", "lognormal", "bernoulli", "measured",
    "randint", "gumbel", "categorical", "draw",
})

# prng derivations: a key passed here yields fresh subkeys.
DERIVERS = frozenset({"split", "fold_in"})

KEY_CONSTRUCTORS = frozenset({"PRNGKey", "fold_in"})

# The port's other spellings of a member: each `*_plain` twin, and the
# kernel wrappers every prng entry point calls ("draw" is any sampler).
_TWINS = {"threefry_fold_in": "fold_in", "threefry_split": "split",
          "threefry_draw": "draw"}

# Nondeterministic sources that must never feed a PRNG key (exact canonical
# paths, or prefixes ending in ".").  torch's global generator is one: its
# state depends on every draw the process made before, and `torch.seed`
# reads the clock.
NONDET_SOURCES = (
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "os.urandom", "os.getpid", "uuid.uuid1", "uuid.uuid4",
    "id", "hash",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
    "random.", "numpy.random.", "secrets.",
    "torch.seed", "torch.initial_seed", "torch.random.",
    "torch.cuda.seed", "torch.cuda.initial_seed",
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
)

# Declared fold_in salt lattices: multiplier -> the invariant that keeps the
# lattice injective.  `s * 10 + b` is the detector's layer_id schedule;
# `DetectorConfig.__post_init__` enforces blocks_per_stage < 10 so
# (s, b) -> s*10+b cannot collide.  New arithmetic salts must be declared
# here (with their runtime guard) or KEY003 flags them.
DECLARED_FOLD_LATTICES: Dict[int, str] = {
    10: "detector layer_id = stage*10 + block; DetectorConfig enforces "
        "blocks_per_stage < 10 (repro_torch.models.detector)",
}


def _prng_member(path: Optional[str]) -> Optional[str]:
    """'repro_torch.prng.normal_plain' -> 'normal',
    'repro_torch.kernels.ops.threefry_draw' -> 'draw'; None otherwise."""
    if path and path.startswith(OPS):
        return _TWINS.get(path[len(OPS):])
    if path and path.startswith(PRNG):
        tail = path[len(PRNG):]
        if "." not in tail:
            return tail[:-len("_plain")] if tail.endswith("_plain") else tail
    return None


@dataclasses.dataclass
class _Scope:
    """Per-function abstract state for the reuse analysis."""
    gen: Dict[str, int] = dataclasses.field(default_factory=dict)
    # (name, generation) -> consumption lines
    consumed: Dict[Tuple[str, int], List[int]] = dataclasses.field(
        default_factory=dict)
    # (name, generation) -> loop depth at which this generation was bound
    origin: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)

    def clone(self) -> "_Scope":
        return _Scope(gen=dict(self.gen),
                      consumed={k: list(v) for k, v in self.consumed.items()},
                      origin=dict(self.origin))

    def merge_branch(self, other: "_Scope") -> None:
        """Join of two exclusive branches: max consumption count per key."""
        for k, lines in other.consumed.items():
            mine = self.consumed.setdefault(k, [])
            if len(lines) > len(mine):
                self.consumed[k] = list(lines)
        for name, g in other.gen.items():
            self.gen[name] = max(self.gen.get(name, 0), g)
        for k, d in other.origin.items():
            self.origin.setdefault(k, d)


class KeyDisciplinePass:
    def __init__(self, path: str, source: str):
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.aliases = collect_import_aliases(self.tree)
        self.findings: List[Finding] = []

    # ------------------------------------------------------------- helpers
    def _member(self, call: ast.Call) -> Optional[str]:
        return _prng_member(canonical(call.func, self.aliases))

    def _key_arg(self, call: ast.Call) -> Optional[ast.AST]:
        if call.args:
            return call.args[0]
        for kw in call.keywords:
            if kw.arg == "key":
                return kw.value
        return None

    # ------------------------------------------------------------ KEY002/3
    def _check_call_rules(self, call: ast.Call, scope_desc: str,
                          fold_sites: Dict[Tuple[str, object],
                                           List[Tuple[int, int]]]) -> None:
        member = self._member(call)
        if member is None:
            return
        if member in KEY_CONSTRUCTORS:
            args = (call.args[1:] if member == "fold_in" else call.args)
            for arg in args:
                for node in ast.walk(arg):
                    if not isinstance(node, ast.Call):
                        continue
                    src = canonical(node.func, self.aliases)
                    if src is None:
                        continue
                    if any(src == p or (p.endswith(".") and
                                        src.startswith(p))
                           for p in NONDET_SOURCES):
                        self.findings.append(Finding(
                            rule="KEY002", file=self.path, line=node.lineno,
                            message=f"PRNG key in {scope_desc} is derived "
                                    f"from nondeterministic source "
                                    f"`{src}()`",
                            hint="seed keys from a recorded root "
                                 "(PRNGKey(seed) + fold_in of stable ids) "
                                 "so the run replays from its manifest"))
        if member == "fold_in" and call.args and len(call.args) >= 2:
            base = dotted_name(call.args[0])
            salt = call.args[1]
            if base is not None and isinstance(salt, ast.Constant) \
                    and isinstance(salt.value, int):
                fold_sites.setdefault((base, salt.value), []).append(
                    (call.lineno, call.col_offset))
            elif base is not None and isinstance(salt, ast.BinOp):
                self._check_lattice(salt, scope_desc)

    def _check_lattice(self, salt: ast.BinOp, scope_desc: str) -> None:
        """`a*C + b` salts must use a declared multiplier C."""
        mults: List[int] = []
        for node in ast.walk(salt):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
                for side in (node.left, node.right):
                    if isinstance(side, ast.Constant) \
                            and isinstance(side.value, int):
                        mults.append(side.value)
        declared = [m for m in mults if m in DECLARED_FOLD_LATTICES]
        if not declared:
            self.findings.append(Finding(
                rule="KEY003", file=self.path, line=salt.lineno,
                message=f"arithmetic fold_in salt in {scope_desc} uses an "
                        f"undeclared lattice "
                        f"(`{ast.unparse(salt)}`)",
                hint="declare the multiplier in repro_torch.analysis.keys."
                     "DECLARED_FOLD_LATTICES with the runtime guard that "
                     "keeps the lattice injective (e.g. s*10+b needs "
                     "b < 10)"))

    # ------------------------------------------------------------- KEY001
    def _consume(self, scope: _Scope, name: str, line: int) -> None:
        g = scope.gen.get(name, 0)
        lines = scope.consumed.setdefault((name, g), [])
        lines.append(line)
        if len(lines) == 2:
            self.findings.append(Finding(
                rule="KEY001", file=self.path, line=line,
                message=f"key `{name}` consumed by a second prng "
                        f"sampler without an intervening split/fold_in "
                        f"(first use at line {lines[0]})",
                hint="derive one subkey per draw: k1, k2 = "
                     "prng.split(key) or prng.fold_in(key, stable_id)"))

    def _scan_expr(self, expr: ast.AST, scope: _Scope,
                   fold_sites, scope_desc: str) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            self._check_call_rules(node, scope_desc, fold_sites)
            member = self._member(node)
            if member in SAMPLERS:
                key_arg = self._key_arg(node)
                name = dotted_name(key_arg) if key_arg is not None else None
                if name is not None:
                    self._consume(scope, name, node.lineno)

    def _bind_targets(self, targets, scope: _Scope, depth: int,
                      value: Optional[ast.AST] = None) -> None:
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._bind_targets(t.elts, scope, depth, value)
            elif isinstance(t, ast.Name):
                g = scope.gen.get(t.id, 0) + 1
                scope.gen[t.id] = g
                scope.origin[(t.id, g)] = depth
            elif isinstance(t, ast.Attribute):
                name = dotted_name(t)
                if name is not None:
                    g = scope.gen.get(name, 0) + 1
                    scope.gen[name] = g
                    scope.origin[(name, g)] = depth
                if value is not None:
                    self._check_key004(t, value)

    def _check_key004(self, target: ast.Attribute, value: ast.AST) -> None:
        for node in ast.walk(value):
            if isinstance(node, ast.Call) and self._member(node) == "split":
                tname = dotted_name(target) or "<attr>"
                self.findings.append(Finding(
                    rule="KEY004", file=self.path, line=target.lineno,
                    message=f"split result stored into mutable state "
                            f"`{tname}`: the key stream advances with call "
                            f"order, so draws depend on request arrival",
                    hint="key draws by stable coordinates instead: "
                         "fold_in(root, wave)/fold_in(wave_key, step)"))
                return

    def _walk_stmts(self, stmts, scope: _Scope, depth: int,
                    fold_sites, scope_desc: str) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue   # nested defs are analyzed as their own scopes
            if isinstance(stmt, ast.Assign):
                self._scan_expr(stmt.value, scope, fold_sites, scope_desc)
                for t in stmt.targets:
                    self._bind_targets([t], scope, depth, stmt.value)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                if stmt.value is not None:
                    self._scan_expr(stmt.value, scope, fold_sites, scope_desc)
                self._bind_targets([stmt.target], scope, depth, stmt.value)
            elif isinstance(stmt, ast.If):
                self._scan_expr(stmt.test, scope, fold_sites, scope_desc)
                branch = scope.clone()
                self._walk_stmts(stmt.body, scope, depth, fold_sites,
                                 scope_desc)
                self._walk_stmts(stmt.orelse, branch, depth, fold_sites,
                                 scope_desc)
                scope.merge_branch(branch)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter, scope, fold_sites, scope_desc)
                self._bind_targets([stmt.target], scope, depth + 1)
                self._loop_body(stmt.body, scope, depth, fold_sites,
                                scope_desc)
                self._walk_stmts(stmt.orelse, scope, depth, fold_sites,
                                 scope_desc)
            elif isinstance(stmt, ast.While):
                self._scan_expr(stmt.test, scope, fold_sites, scope_desc)
                self._loop_body(stmt.body, scope, depth, fold_sites,
                                scope_desc)
                self._walk_stmts(stmt.orelse, scope, depth, fold_sites,
                                 scope_desc)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr(item.context_expr, scope, fold_sites,
                                    scope_desc)
                self._walk_stmts(stmt.body, scope, depth, fold_sites,
                                 scope_desc)
            elif isinstance(stmt, ast.Try):
                self._walk_stmts(stmt.body, scope, depth, fold_sites,
                                 scope_desc)
                for h in stmt.handlers:
                    self._walk_stmts(h.body, scope, depth, fold_sites,
                                     scope_desc)
                self._walk_stmts(stmt.orelse, scope, depth, fold_sites,
                                 scope_desc)
                self._walk_stmts(stmt.finalbody, scope, depth, fold_sites,
                                 scope_desc)
            elif isinstance(stmt, (ast.Expr, ast.Return)):
                if stmt.value is not None:
                    self._scan_expr(stmt.value, scope, fold_sites, scope_desc)
            elif isinstance(stmt, (ast.Assert, ast.Raise, ast.Delete)):
                for node in ast.iter_child_nodes(stmt):
                    self._scan_expr(node, scope, fold_sites, scope_desc)

    def _loop_body(self, body, scope: _Scope, depth: int, fold_sites,
                   scope_desc: str) -> None:
        """One symbolic pass over a loop body; afterwards any consumption of
        a key bound OUTSIDE the loop is a cross-iteration reuse (the loop
        replays the same draw every iteration)."""
        before = {k: len(v) for k, v in scope.consumed.items()}
        self._walk_stmts(body, scope, depth + 1, fold_sites, scope_desc)
        for (name, g), lines in scope.consumed.items():
            new = lines[before.get((name, g), 0):]
            if not new:
                continue
            if scope.origin.get((name, g), 0) <= depth and len(lines) == 1:
                # a single in-loop consumption of an outer key still repeats
                # per iteration; >=2 was already flagged by _consume
                self.findings.append(Finding(
                    rule="KEY001", file=self.path, line=new[0],
                    message=f"key `{name}` bound outside the loop is "
                            f"consumed inside it: every iteration replays "
                            f"the same draw",
                    hint="fold the loop index in: "
                         "prng.fold_in(key, i)"))

    # ----------------------------------------------------------------- run
    def run(self) -> List[Finding]:
        # module scope
        module_scope = _Scope()
        fold_sites: Dict[Tuple[str, object], List[Tuple[int, int]]] = {}
        self._walk_stmts(self.tree.body, module_scope, 0, fold_sites,
                         "<module>")
        self._flag_fold_collisions(fold_sites, "<module>")
        for qualname, fn in walk_functions(self.tree):
            scope = _Scope()
            for a in (*fn.args.posonlyargs, *fn.args.args,
                      *fn.args.kwonlyargs):
                scope.origin[(a.arg, 0)] = 0
            sites: Dict[Tuple[str, object], List[Tuple[int, int]]] = {}
            self._walk_stmts(fn.body, scope, 0, sites, f"`{qualname}`")
            self._flag_fold_collisions(sites, f"`{qualname}`")
        return self.findings

    def _flag_fold_collisions(self, fold_sites, scope_desc: str) -> None:
        for (base, salt), sites in fold_sites.items():
            if len(set(sites)) >= 2:
                line = sorted(set(sites))[1][0]
                self.findings.append(Finding(
                    rule="KEY003", file=self.path, line=line,
                    message=f"two call sites in {scope_desc} derive the "
                            f"same subkey fold_in({base}, {salt})",
                    hint="give each derivation a distinct salt (or hoist "
                         "the shared subkey into one binding)"))


def run_key_pass(path: str, source: str) -> List[Finding]:
    return KeyDisciplinePass(path, source).run()
