"""AST linter of the port's trace contracts, restated in PyTorch's terms.

Counterpart of `repro.analysis.astcheck`. Every execution tier of the
port runs ONE step function per algorithm over a leading runs axis
(`repro_torch.methods.base`), and its performance and parity rest on
contracts visible in source. This module makes them lint rules over
``src/repro_torch``:

- ``host-rng-in-device-code``: ``prepare`` samples everything random
  from numpy streams on the host, so codes, schedules and noise stay
  bitwise equal to `repro`'s. Device-side kernel methods (setup/init/
  step/final and the hooks they call) and the functions under
  ``repro_torch/kernels`` must not touch ``np.random``/``random``, nor
  torch's generators: ``torch.rand*``, ``torch.normal``,
  ``torch.bernoulli``, ``torch.multinomial``, ``torch.manual_seed`` and
  the in-place ``Tensor.uniform_``/``normal_``/``random_``/
  ``bernoulli_``/``exponential_``.
- ``device-tensor-in-host-prepare``: the host side of the split
  (``prepare``/``config``/``static_signature``/``max_statics_bound`` and
  what they call) stays numpy; the name ``torch`` there means a tensor
  is made before `prepared_to_device` places the stacked batch.
- ``host-sync-in-step``: nothing in a device-side method may make the
  host wait for the card inside the step loop — a Python ``if``/
  ``while``/``assert``/conditional expression or a ``bool``/``float``/
  ``int`` on a tensor value; ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` on one; ``torch.cuda.synchronize``, ``torch.nonzero``/
  ``.nonzero()``, ``torch.unique``/``.unique()``, ``print``. Branching is
  legal on ``statics`` and on Python-level facts of a tensor
  (``.shape``, ``.dtype``, ``.device``, ``len()``). This takes the place
  of the reference's ``traced-python-control-flow`` and
  ``callback-in-scan-body``: PyTorch runs eagerly, so a branch on a
  tensor does not fail to trace, it synchronises.
- ``spec-dataclass-not-frozen``: spec dataclasses (``*Config``, ``*Run``,
  ``*Spec``, `Case`, `Reduction`, `TimingModel`, ...) are batch-grouping
  and dedupe keys; they must be ``frozen=True`` with no mutable default.
- ``statics-key-not-in-signature``: every ``statics[...]`` key a
  device-side method reads must be produced by some kernel's host-side
  statics construction.

Stdlib ``ast`` only: no torch import, so it runs cold. Class relations
are resolved by name across the linted files (`MethodKernel` subclasses
found transitively), and each class's methods are split into host and
device sides by a ``self.``-call fixpoint from the protocol's entry
points; a method reachable from both sides is skipped as ambiguous.
Known-bad fixtures: ``tests/fixtures/torch_lint``.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "RULES", "lint_paths"]


RULES: Dict[str, str] = {
    "host-rng-in-device-code": (
        "host or torch RNG inside device-side kernel code"
    ),
    "device-tensor-in-host-prepare": (
        "torch usage inside a host-side (prepare-path) kernel method"
    ),
    "host-sync-in-step": (
        "host synchronisation on a tensor value in a device-side method"
    ),
    "spec-dataclass-not-frozen": (
        "spec dataclass not frozen=True, or carries a mutable default"
    ),
    "statics-key-not-in-signature": (
        "statics key read device-side but never produced by any "
        "host-side statics construction"
    ),
}

# The MethodKernel protocol's fixed entry points.
_DEVICE_SEED = ("setup", "init", "step", "final")
_HOST_SEED = ("config", "static_signature", "prepare", "max_statics_bound")

# Spec dataclasses are grouping keys; result containers are not.
_SPEC_SUFFIXES = ("Config", "Run", "Spec")
_SPEC_NAMES = {"Case", "Reduction", "TimingModel", "GradientCode",
               "CodeFamily"}
_SPEC_ALLOWLIST = {"SweepResult", "Prepared"}

# Tensor attributes (and methods) whose value is Python-level.
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "device", "dim",
                 "numel"}
# Builtins whose result is Python-level even for tensor arguments.
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "range",
                 "min", "max", "sorted", "enumerate", "zip"}
_CAST_CALLS = {"bool", "float", "int", "complex"}
# Methods that copy a tensor's value to the host.
_TO_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# Calls that synchronise whatever their arguments.
_SYNC_CALLS = {"torch.cuda.synchronize", "torch.nonzero", "torch.unique",
               "print"}
_SYNC_METHODS = {"nonzero", "unique"}
# Draws from an RNG: numpy's and Python's (attribute prefixes), torch's
# functions (name prefixes) and torch's in-place samplers (methods).
_HOST_RNG_PREFIXES = ("np.random", "numpy.random", "random.")
_TORCH_RNG_PREFIXES = ("torch.rand", "torch.normal", "torch.bernoulli",
                       "torch.multinomial", "torch.manual_seed")
_TORCH_RNG_METHODS = {"uniform_", "normal_", "random_", "bernoulli_",
                      "exponential_"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# --------------------------------------------------------------------------
# Small AST helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """Last component of a class base expression (Name or Attribute)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_dataclass_decorator(dec: ast.AST) -> Optional[ast.Call]:
    """The decorator Call if ``dec`` is (a call of) dataclass, else a
    sentinel empty Call for the bare form, else None."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _dotted(target)
    if name in ("dataclass", "dataclasses.dataclass"):
        return dec if isinstance(dec, ast.Call) else ast.Call(
            func=target, args=[], keywords=[]
        )
    return None


def _is_mutable_default(value: ast.AST) -> bool:
    """Would this default expression alias shared mutable state?"""
    if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        name = _dotted(value.func) or ""
        if name in ("list", "dict", "set", "bytearray"):
            return True
        if name.startswith(("np.", "numpy.", "torch.")):
            return True
    return False


# --------------------------------------------------------------------------
# Project index: classes, kernel resolution, method classification
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ClassInfo:
    name: str
    path: pathlib.Path
    node: ast.ClassDef
    bases: Tuple[str, ...]

    def methods(self) -> Dict[str, ast.FunctionDef]:
        return {
            item.name: item
            for item in self.node.body
            if isinstance(item, ast.FunctionDef)
        }


class _Index:
    """Name-resolved view of every linted module (stdlib-only)."""

    def __init__(self, files: Dict[pathlib.Path, ast.Module]):
        self.files = files
        self.classes: Dict[str, List[_ClassInfo]] = {}
        for path, tree in files.items():
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    bases = tuple(
                        b for b in map(_base_name, node.bases) if b
                    )
                    self.classes.setdefault(node.name, []).append(
                        _ClassInfo(node.name, path, node, bases)
                    )

    def kernel_classes(self) -> List[_ClassInfo]:
        """Transitive subclasses of MethodKernel, resolved by base name."""
        kernel_names: Set[str] = {"MethodKernel"}
        changed = True
        while changed:
            changed = False
            for name, infos in self.classes.items():
                if name in kernel_names:
                    continue
                if any(
                    b in kernel_names for info in infos for b in info.bases
                ):
                    kernel_names.add(name)
                    changed = True
        out = []
        for name in kernel_names:
            out.extend(self.classes.get(name, []))
        return sorted(out, key=lambda c: (str(c.path), c.node.lineno))

    def flattened_methods(
        self, cls: _ClassInfo
    ) -> Dict[str, ast.FunctionDef]:
        """Own methods + nearest inherited ones (name-resolved MRO-ish)."""
        resolved: Dict[str, ast.FunctionDef] = {}
        seen: Set[str] = set()
        queue: List[_ClassInfo] = [cls]
        while queue:
            info = queue.pop(0)
            if info.name in seen:
                continue
            seen.add(info.name)
            for mname, fn in info.methods().items():
                resolved.setdefault(mname, fn)
            for base in info.bases:
                queue.extend(self.classes.get(base, []))
        return resolved


def _self_calls(fn: ast.FunctionDef) -> Set[str]:
    """Names of methods invoked as ``self.X(...)`` / ``cls.X(...)``."""
    calls: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            root = node.func.value
            if isinstance(root, ast.Name) and root.id in ("self", "cls"):
                calls.add(node.func.attr)
    return calls


def _classify(
    index: _Index, cls: _ClassInfo
) -> Tuple[Set[str], Set[str]]:
    """(device_methods, host_methods) for one kernel class, by fixpoint
    over the ``self.``-call graph from the protocol's entry points."""
    flat = index.flattened_methods(cls)

    def expand(seed: Iterable[str], other_seed: Set[str]) -> Set[str]:
        members = {m for m in seed if m in flat}
        changed = True
        while changed:
            changed = False
            for m in sorted(members):
                for callee in _self_calls(flat[m]):
                    if (
                        callee in flat
                        and callee not in members
                        and callee not in other_seed
                    ):
                        members.add(callee)
                        changed = True
        return members

    device = expand(_DEVICE_SEED, set(_HOST_SEED))
    host = expand(_HOST_SEED, set(_DEVICE_SEED))
    ambiguous = device & host
    return device - ambiguous, host - ambiguous


# --------------------------------------------------------------------------
# Statics-key production (host side) and consumption (device side)
# --------------------------------------------------------------------------


def _produced_statics_keys(fn: ast.FunctionDef) -> Set[str]:
    """String keys this host-side method contributes to a statics dict:
    ``dict(...)`` call keywords, dict-literal string keys, and
    ``statics["key"] = ...`` subscript assignments."""
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _dotted(node.func) == "dict":
            for kw in node.keywords:
                if kw.arg is not None:
                    keys.add(kw.arg)
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    keys.add(key.value)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Subscript)
                    and isinstance(target.slice, ast.Constant)
                    and isinstance(target.slice.value, str)
                ):
                    keys.add(target.slice.value)
    return keys


def _consumed_statics_keys(
    fn: ast.FunctionDef,
) -> List[Tuple[str, int]]:
    """(key, line) for every ``statics[...]`` / ``statics.get(...)``."""
    reads: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == "statics"
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            reads.append((node.slice.value, node.lineno))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "statics"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            reads.append((node.args[0].value, node.lineno))
    return reads


# --------------------------------------------------------------------------
# Which values are Python-level inside a device-side body
# --------------------------------------------------------------------------


class _TraceSafety:
    """Which expressions are Python-level (safe to branch on) inside a
    device-side method. Parameters other than ``self``/``statics`` hold
    tensors; locals inherit safety from their right-hand side in source
    order; ``.shape``-style attributes and ``len()`` of tensors are
    Python-level. A call is Python-level when its callee and every
    argument are (so ``x.size(0)`` and ``statics.get("K")`` are, and
    ``x.sum()`` or ``torch.any(x)`` are not)."""

    def __init__(self, fn: ast.FunctionDef):
        args = fn.args
        names = [
            a.arg
            for a in (
                list(args.posonlyargs) + list(args.args)
                + list(args.kwonlyargs)
            )
        ]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        self.unsafe: Set[str] = {
            n for n in names if n not in ("self", "cls", "statics")
        }
        # One pass in source order: assignment targets inherit safety.
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                self._bind(node.targets, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._bind([node.target], node.value)
            elif isinstance(node, ast.AugAssign):
                self._bind([node.target], node.value)
            elif isinstance(node, ast.For):
                self._bind([node.target], node.iter)
            elif isinstance(node, ast.withitem) and node.optional_vars:
                self._bind([node.optional_vars], node.context_expr)

    def _bind(self, targets: Sequence[ast.AST], value: ast.AST) -> None:
        tainted = not self.is_safe(value)
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            elif isinstance(t, ast.Starred):
                stack.append(t.value)
            elif isinstance(t, ast.Name) and tainted:
                self.unsafe.add(t.id)

    def is_safe(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) or node is None:
            return True
        if isinstance(node, ast.Name):
            return node.id not in self.unsafe
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return True
            return self.is_safe(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_safe(node.value) and self.is_safe(node.slice)
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in _STATIC_CALLS:
                return True
            if not (
                isinstance(node.func, ast.Attribute) or name in _CAST_CALLS
            ):
                return False
            return (
                self.is_safe(node.func)
                and all(self.is_safe(a) for a in node.args)
                and all(self.is_safe(k.value) for k in node.keywords)
            )
        if isinstance(node, ast.Compare):
            # Key membership on dicts is Python-level: `"Gt" in aux`
            if all(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
            ) and isinstance(node.left, ast.Constant):
                return True
            return self.is_safe(node.left) and all(
                self.is_safe(c) for c in node.comparators
            )
        if isinstance(node, (ast.BoolOp,)):
            return all(self.is_safe(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.is_safe(node.left) and self.is_safe(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_safe(node.operand)
        if isinstance(node, ast.IfExp):
            return (
                self.is_safe(node.test)
                and self.is_safe(node.body)
                and self.is_safe(node.orelse)
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return all(self.is_safe(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return all(
                self.is_safe(k) for k in node.keys if k is not None
            ) and all(self.is_safe(v) for v in node.values)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            return True
        if isinstance(node, ast.Starred):
            return self.is_safe(node.value)
        if isinstance(node, ast.Slice):
            return all(
                self.is_safe(p)
                for p in (node.lower, node.upper, node.step)
                if p is not None
            )
        return False  # lambdas, comprehensions, await, ...: conservative


# --------------------------------------------------------------------------
# Per-method rule passes
# --------------------------------------------------------------------------


def _rng_use(node: ast.AST) -> Optional[str]:
    """The RNG draw this node makes, as written, or None."""
    if isinstance(node, ast.Attribute):
        name = _dotted(node) or ""
        if name.startswith(_HOST_RNG_PREFIXES):
            return name
    if isinstance(node, ast.Call):
        name = _dotted(node.func) or ""
        if name.startswith(_TORCH_RNG_PREFIXES):
            return name
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _TORCH_RNG_METHODS
        ):
            return f".{node.func.attr}()"
    return None


def _sync_use(node: ast.AST, safety: _TraceSafety) -> Optional[str]:
    """Why this node makes the host wait for the card, or None."""
    if isinstance(node, (ast.If, ast.While)) and not safety.is_safe(
        node.test
    ):
        kw = "if" if isinstance(node, ast.If) else "while"
        return (
            f"Python `{kw}` on a tensor value — branch on statics or use "
            "torch.where"
        )
    if isinstance(node, ast.IfExp) and not safety.is_safe(node.test):
        return "conditional expression on a tensor value"
    if isinstance(node, ast.Assert) and not safety.is_safe(node.test):
        return "`assert` on a tensor value"
    if not isinstance(node, ast.Call):
        return None
    name = _dotted(node.func) or ""
    if name in _SYNC_CALLS:
        return f"`{name}()` synchronises with the host"
    if name in _CAST_CALLS and any(
        not safety.is_safe(a) for a in node.args
    ):
        return f"`{name}()` on a tensor value"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _SYNC_METHODS:
            return f"`.{attr}()` synchronises with the host"
        if attr in _TO_HOST_METHODS and not safety.is_safe(node.func.value):
            return f"`.{attr}()` on a tensor value copies it to the host"
    return None


def _check_device_method(
    fn: ast.FunctionDef,
    rel: str,
    produced: Set[str],
    findings: List[Finding],
) -> None:
    safety = _TraceSafety(fn)
    for node in ast.walk(fn):
        rng = _rng_use(node)
        if rng is not None:
            findings.append(Finding(
                "host-rng-in-device-code", rel, node.lineno,
                f"`{rng}` in device-side method `{fn.name}` — sample "
                "host-side in prepare() from a numpy stream",
            ))
        why = _sync_use(node, safety)
        if why is not None:
            findings.append(Finding(
                "host-sync-in-step", rel, node.lineno,
                f"{why} in device-side method `{fn.name}`",
            ))
    for key, line in _consumed_statics_keys(fn):
        if key not in produced:
            findings.append(Finding(
                "statics-key-not-in-signature", rel, line,
                f"statics[{key!r}] read in `{fn.name}` but no host-side "
                "statics construction produces it — add it to the "
                "prepared statics/static_signature",
            ))


def _check_host_method(
    fn: ast.FunctionDef, rel: str, findings: List[Finding]
) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "torch":
            findings.append(Finding(
                "device-tensor-in-host-prepare", rel, node.lineno,
                f"`torch` used in host-side method `{fn.name}` — the "
                "prepare path is numpy; prepared_to_device makes the "
                "tensors",
            ))


def _check_kernels_module_fn(
    fn: ast.FunctionDef, rel: str, findings: List[Finding]
) -> None:
    """The RNG rule for kernel modules (everything under
    ``repro_torch/kernels`` runs on the step's device path)."""
    for node in ast.walk(fn):
        rng = _rng_use(node)
        if rng is not None:
            findings.append(Finding(
                "host-rng-in-device-code", rel, node.lineno,
                f"`{rng}` in kernel module function `{fn.name}`",
            ))


# --------------------------------------------------------------------------
# Module-scope rules
# --------------------------------------------------------------------------


def _check_spec_dataclasses(
    tree: ast.Module, rel: str, findings: List[Finding]
) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        deco = None
        for dec in node.decorator_list:
            deco = _is_dataclass_decorator(dec)
            if deco is not None:
                break
        if deco is None:
            continue
        is_spec = (
            node.name.endswith(_SPEC_SUFFIXES) or node.name in _SPEC_NAMES
        ) and node.name not in _SPEC_ALLOWLIST
        if not is_spec:
            continue
        frozen = any(
            kw.arg == "frozen"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in deco.keywords
        )
        if not frozen:
            findings.append(Finding(
                "spec-dataclass-not-frozen", rel, node.lineno,
                f"spec dataclass `{node.name}` must be "
                "@dataclasses.dataclass(frozen=True) — it is a batch "
                "grouping / grid dedupe key",
            ))
        for item in node.body:
            value = None
            if isinstance(item, ast.AnnAssign):
                value = item.value
            elif isinstance(item, ast.Assign):
                value = item.value
            if value is None:
                continue
            if isinstance(value, ast.Call) and (
                _dotted(value.func) or ""
            ).endswith("field"):
                for kw in value.keywords:
                    if kw.arg == "default" and _is_mutable_default(
                        kw.value
                    ):
                        findings.append(Finding(
                            "spec-dataclass-not-frozen", rel,
                            item.lineno,
                            f"mutable field default in `{node.name}`",
                        ))
            elif _is_mutable_default(value):
                findings.append(Finding(
                    "spec-dataclass-not-frozen", rel, item.lineno,
                    f"mutable default in spec dataclass `{node.name}` — "
                    "shared across every instance",
                ))


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def _iter_files(paths: Sequence[pathlib.Path]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        else:
            out.append(p)
    return out


def lint_paths(
    paths: Sequence[pathlib.Path],
    root: Optional[pathlib.Path] = None,
) -> List[Finding]:
    """Lint files/directories; returns findings sorted by location.

    ``root`` only affects how paths are reported. Statics-key production
    is collected across ALL given paths before consumption is checked, so
    lint the whole tree (or one self-contained fixture file) at once.
    """
    files: Dict[pathlib.Path, ast.Module] = {}
    rels: Dict[pathlib.Path, str] = {}
    findings: List[Finding] = []
    for path in _iter_files(paths):
        try:
            rel = str(
                path.relative_to(root) if root is not None else path
            )
        except ValueError:
            rel = str(path)
        rels[path] = rel
        try:
            files[path] = ast.parse(
                path.read_text(encoding="utf-8"), filename=str(path)
            )
        except SyntaxError as exc:
            findings.append(Finding(
                "syntax-error", rel, exc.lineno or 0, str(exc.msg)
            ))
    index = _Index(files)

    # Pass 1: classify every kernel class's methods; collect produced
    # statics keys from all host-side methods.
    device_defs: Dict[int, Tuple[ast.FunctionDef, str]] = {}
    host_defs: Dict[int, Tuple[ast.FunctionDef, str]] = {}
    ambiguous: Set[int] = set()
    produced: Set[str] = set()
    for cls in index.kernel_classes():
        device, host = _classify(index, cls)
        for mname, fn in cls.methods().items():
            key = id(fn)
            if mname in device:
                if key in host_defs:
                    ambiguous.add(key)
                device_defs[key] = (fn, rels[cls.path])
            elif mname in host:
                if key in device_defs:
                    ambiguous.add(key)
                host_defs[key] = (fn, rels[cls.path])
        # Produced keys come from the class's full host-side view
        # (inherited prepare produces keys a subclass's step consumes).
        flat = index.flattened_methods(cls)
        for mname in host:
            produced |= _produced_statics_keys(flat[mname])

    # Pass 2: per-method rules.
    for key, (fn, rel) in device_defs.items():
        if key not in ambiguous:
            _check_device_method(fn, rel, produced, findings)
    for key, (fn, rel) in host_defs.items():
        if key not in ambiguous:
            _check_host_method(fn, rel, findings)

    # Pass 3: module-scope rules.
    for path, tree in files.items():
        rel = rels[path]
        _check_spec_dataclasses(tree, rel, findings)
        if "/kernels/" in str(path).replace("\\", "/"):
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef):
                    _check_kernels_module_fn(node, rel, findings)

    # Dedupe nested-attribute double hits at one location.
    seen: Set[Tuple[str, str, int]] = set()
    unique: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        loc = (f.rule, f.path, f.line)
        if loc not in seen:
            seen.add(loc)
            unique.append(f)
    return unique
