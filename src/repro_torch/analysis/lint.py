"""Repo-specific AST lint passes for the port's serving core (the
counterpart of ``repro.analysis.lint``, retargeted at PyTorch).

All passes are pure-AST (no imports of the analysed code):

**host-sync** — device→host synchronisations reachable from the serve
hot path (``OfflineEngine.step``, both backends' ``decode`` /
``prefill_step``, and both pipeline tick functions).  Flags ``.item()``,
``.cpu()``, ``torch.cuda.synchronize`` and ``Stream`` / ``Event``
``.synchronize()`` anywhere in the reachable set, and ``.tolist()`` /
``.numpy()`` / ``np.array`` / ``np.asarray`` / ``int()`` / ``float()`` /
``bool()`` / a Python ``if`` or ``while`` applied to a *device-tracked*
tensor — names bound from ``torch.*`` producers, model and kernel calls
(``decode_step``, ``prefill_chunk``, the tick functions, the attention
and scan wrappers), or the sampler helpers (``sample_batched``, ...).
Shape, dtype and device reads, ``is None`` tests and ``isinstance`` /
``len`` are host-side and never flagged.  One accidental sync per tick
stalls the host's launch queue behind the card.

**offload-sync** — blocking host synchronisations inside the KV
offloader's *engaged window* (``DoubleBufferOffloader.ensure_resident``,
``_swap_on_copy_stream`` and ``_stage_out``).  The double-buffer schedule
only hides swap cost if the swap is enqueued on the copy stream — a
``.synchronize()`` / ``.item()`` / ``.cpu()`` / ``np.asarray`` or a call
of the offloader's own barriers (``block_until_ready``, ``settle``)
there serialises the swap behind the tick.  The deliberate blocking
fallback (``async_swap=False``) carries a reasoned suppression.

**obs-hot-path** — flight-recorder discipline for
:mod:`repro_torch.obs`: a recording call (any dotted call routed through
a recorder name — ``self.recorder.span(...)``, ``rec.link_send(...)``)
anywhere in the reachable hot set whose arguments reference a
device-tracked value is flagged — recording must read only host values
the engine already holds, or it adds the very device sync the flight
recorder is designed never to add.

**retrace-jit** — a kernel library built or loaded
(``build.build`` / ``build.build_many`` / ``build.load``), a
``torch.compile``, or a CUDA graph capture (``torch.cuda.graph``,
``CUDAGraph``, ``make_graphed_callables``) or ``torch.jit`` script or
trace constructed inside a hot-path function: each costs a compile or a
capture per call unless it is memoised (the kernel wrappers' memoised
``_library()`` loads carry a reasoned suppression, and the runtime
auditor checks that no library is built or loaded again mid-serve).

**prng-fold-drop** — a ``Generator.manual_seed`` / ``torch.manual_seed``
whose seed is a known short chain of the serving discipline
``token_seed(request_seed(seed, request_id), token_idx)``
(``repro_torch.serving.sampler``): a raw literal seed drops both
``request_id`` and ``token_idx``; ``request_seed(...)`` alone drops
``token_idx``; ``token_seed(<raw>, ...)`` drops ``request_id``.  Either
collapses streams across requests or positions.  Seeds whose chain the
AST cannot see (parameters, helper results) are never flagged.

Rules of the reference with no PyTorch meaning:

* ``retrace-branch`` — eager PyTorch traces nothing; a Python branch on
  a tensor is a host sync, which ``host-sync`` reports.
* ``retrace-nonhashable`` — no jit cache: a ``functools.partial`` kwarg
  has no cache key to defeat.
* ``prng-reuse`` — a ``torch.Generator`` is stateful: two draws from one
  generator are two different streams, never identical ones.

The obs-hot-path rule's other half in the reference (a recording call
inside a tick-jit body) has no counterpart either: the port's ticks are
plain Python, and a recording call there runs on the host like any
other.

Suppressions: ``# repro-torch-audit: allow(<rule>[, <rule>...]) —
<reason>`` on the offending line, or on a comment line above it (the
comment lines between are skipped, so the JAX lint's own
``# repro-audit: allow(...)`` marker may sit right above the code).  The
marker differs from the reference's so each lint's ``--strict-
suppressions`` sees only its own: both lints scan the port.  Under
``--strict-suppressions`` every suppression must carry a non-empty
reason and must actually suppress something (``bad-suppression`` /
``unused-suppression``).

Configuration is baked in: the hot roots are the reference's
suffix-matched names (``pyproject.toml``'s ``[tool.repro-audit]`` is the
reference lint's and is not read here).

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \\
        --strict-suppressions
"""

from __future__ import annotations

import argparse
import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

# the reference's hot roots (suffix-matched, so they name the port's own
# functions); the port has no tick jits, so there is no traced_fns list
DEFAULT_HOT_ROOTS = [
    "serving.engine:OfflineEngine.step",
    "serving.backend:LocalBackend.decode",
    "serving.backend:LocalBackend.prefill_step",
    "serving.backend:PipelinedBackend.decode",
    "serving.backend:PipelinedBackend.prefill_step",
    "core.pipeline:pipeline_decode_tick",
    "core.pipeline:pipeline_prefill_chunk_tick",
]
# function parameters that carry device tensors into hot-path helpers
# (pure AST cannot see types; the serve seam passes logits rows around)
DEVICE_PARAMS = ["logits", "logits_row"]
# the offloader's engaged window: functions that run between ticks and
# must only *enqueue* copies on the copy stream, never block on them
DEFAULT_OFFLOAD_WINDOWS = [
    "core.offload:DoubleBufferOffloader.ensure_resident",
    "core.offload:DoubleBufferOffloader._swap_on_copy_stream",
    "core.offload:DoubleBufferOffloader._stage_out",
]
# names a flight-recorder handle travels under: a call whose dotted path
# routes through one of these (``self.recorder.span``, ``rec.fault``) is
# an obs recording call for the obs-hot-path pass
OBS_ROOTS = ["recorder", "rec"]

RULES = ("host-sync", "offload-sync", "obs-hot-path", "retrace-jit",
         "prng-fold-drop", "bad-suppression", "unused-suppression")

# calls that block on the card wherever they appear in the hot set
ALWAYS_SYNC = {"torch.cuda.synchronize"}
# methods that synchronise whatever their receiver: ``.item()`` and
# ``.cpu()`` copy a tensor to the host, ``.synchronize()`` waits for a
# stream or an event
SYNC_METHODS = {"item", "cpu", "synchronize"}
# methods that materialise a tensor on the host: flagged on a
# device-tracked receiver
HOST_METHODS = {"tolist", "numpy"}
# host materialisers: flagged only when fed a device-tracked value
HOST_CASTS = {"int", "float", "bool"}
HOST_NP = {"np.array", "np.asarray", "np.copy", "numpy.array",
           "numpy.asarray", "numpy.copy"}
# the offloader's own barriers (offload-sync inside the engaged window)
OFFLOAD_BARRIERS = {"block_until_ready", "settle"}
# attribute reads and methods that stay on the host (no sync)
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "nbytes", "device",
                "is_cuda", "numel", "dim", "element_size", "stride",
                "data_ptr", "is_pinned", "is_contiguous", "itemsize"}
# builtins that read only a tensor's shape or type
STATIC_CALLS = {"isinstance", "len", "callable", "id", "type"}
# call-name prefixes/names whose results live on the device
DEVICE_PREFIXES = ("torch.",)
DEVICE_NAMES = {
    # the sampler helpers
    "sample_batched", "greedy", "token_logprobs", "gumbel_noise",
    # model calls
    "decode_step", "prefill_chunk", "prefill", "run_layers",
    "_decode_fn", "_chunk_fn", "_prefill_fn", "slot_view",
    "pipeline_decode_tick", "pipeline_prefill_chunk_tick",
    # kernel wrappers
    "paged_decode_attention", "flash_attention", "rglru_scan",
    "paged_chunk_attention",
}
# torch calls whose results are NOT device tensors
DEVICE_EXCEPTIONS = {"torch.device", "torch.Generator", "torch.from_numpy",
                     "torch.finfo", "torch.iinfo", "torch.is_tensor",
                     "torch.inference_mode", "torch.no_grad",
                     "torch.get_default_dtype", "torch.manual_seed"}
DEVICE_EXCEPTION_PREFIXES = ("torch.cuda.", "torch.backends.",
                             "torch.distributed.",
                             # a kernel's ctypes entry point (``lib.`` the
                             # loaded library) returns a C status code
                             "lib.")

# retrace-jit: builds, loads, compiles and captures
BUILD_CALLS = {"build.build", "build.build_many", "build.load",
               "torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
               "torch.cuda.make_graphed_callables", "torch.jit.script",
               "torch.jit.trace"}

# prng-fold-drop: the seed chain of repro_torch.serving.sampler
SEED_REQUEST = "request_seed"
SEED_TOKEN = "token_seed"


@dataclass
class AuditConfig:
    """The functions a run treats as hot roots and as the offload window
    (tests point them at fixtures)."""
    hot_roots: List[str] = field(default_factory=lambda:
                                 list(DEFAULT_HOT_ROOTS))
    offload_windows: List[str] = field(default_factory=lambda:
                                       list(DEFAULT_OFFLOAD_WINDOWS))


# ---------------------------------------------------------------------------
# Indexing: functions, calls, suppressions
# ---------------------------------------------------------------------------


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    msg: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.msg}"


@dataclass
class Suppression:
    path: str
    line: int
    rules: Set[str]
    reason: str
    target: int = 0                 # the code line a comment-line marker
    used: bool = False              # covers (0: its own line only)


@dataclass
class FuncInfo:
    module: str                   # dotted module ("serving.backend")
    qual: str                     # "Class.method" or "func"
    path: str
    node: ast.AST                 # FunctionDef / AsyncFunctionDef

    @property
    def full(self) -> str:
        return f"{self.module}:{self.qual}"

    @property
    def bare(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


_SUPPRESS_RE = re.compile(
    r"#\s*repro-torch-audit:\s*allow\(([^)]*)\)\s*(?:[-—–]+\s*(\S.*))?")


def _collect_suppressions(path: str, source: str) -> List[Suppression]:
    # real COMMENT tokens only — the syntax quoted in a docstring or
    # string literal is documentation, not a suppression
    out = []
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = [(i, line) for i, line in
                    enumerate(source.splitlines(), start=1)
                    if line.lstrip().startswith("#")]
    for i, text in comments:
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            # a marker on a comment line covers the first code line below
            # it, past the other comments between (the JAX lint's own
            # marker may sit on the line right above the code)
            target = i
            if lines[i - 1].lstrip().startswith("#"):
                target = i + 1
                while target <= len(lines) and \
                        lines[target - 1].lstrip().startswith("#"):
                    target += 1
            out.append(Suppression(path=path, line=i, rules=rules,
                                   reason=(m.group(2) or "").strip(),
                                   target=target))
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """Best-effort dotted name of a Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:                       # e.g. x[0].foo → ".foo" tail only
        return "." + ".".join(reversed(parts))
    return None


class _FuncCollector(ast.NodeVisitor):
    def __init__(self, module: str, path: str):
        self.module = module
        self.path = path
        self.stack: List[str] = []
        self.funcs: List[FuncInfo] = []

    def visit_ClassDef(self, node: ast.ClassDef):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _func(self, node):
        qual = ".".join(self.stack + [node.name])
        self.funcs.append(FuncInfo(self.module, qual, self.path, node))
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _func
    visit_AsyncFunctionDef = _func


@dataclass
class FileIndex:
    path: str
    module: str
    tree: ast.AST
    funcs: List[FuncInfo]
    suppressions: List[Suppression]


def _module_name(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def index_paths(paths: Sequence[Path]) -> Tuple[List[FileIndex],
                                                List[Violation]]:
    files: List[FileIndex] = []
    errors: List[Violation] = []
    for root in paths:
        py_files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        base = root.parent if root.is_file() else root
        for f in py_files:
            try:
                src = f.read_text()
                tree = ast.parse(src, filename=str(f))
            except (OSError, SyntaxError) as e:
                errors.append(Violation("parse-error", str(f),
                                        getattr(e, "lineno", 0) or 0,
                                        str(e)))
                continue
            mod = _module_name(f, base)
            col = _FuncCollector(mod, str(f))
            col.visit(tree)
            files.append(FileIndex(str(f), mod, tree, col.funcs,
                                   _collect_suppressions(str(f), src)))
    return files, errors


# ---------------------------------------------------------------------------
# Call graph + reachability
# ---------------------------------------------------------------------------


def _calls_of(fn: FuncInfo) -> List[Tuple[str, ast.Call]]:
    out = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name:
                out.append((name, node))
    return out


def _match_spec(fn: FuncInfo, spec: str) -> bool:
    return fn.full.endswith(spec) or fn.qual == spec


def reachable_functions(files: Sequence[FileIndex],
                        roots: Sequence[str]) -> Set[str]:
    """Transitive closure of the hot roots over a name-based call graph:
    a call ``a.b.c(...)`` edges to every function named ``c`` anywhere in
    the indexed tree.  Deliberately an over-approximation — reachability
    gates *reporting*, and a missed edge hides a real sync while a
    spurious edge only asks for one explained suppression."""
    by_bare: Dict[str, List[FuncInfo]] = {}
    by_full: Dict[str, FuncInfo] = {}
    for fi in files:
        for fn in fi.funcs:
            by_bare.setdefault(fn.bare, []).append(fn)
            by_full[fn.full] = fn
    work = [fn.full for fi in files for fn in fi.funcs
            if any(_match_spec(fn, r) for r in roots)]
    seen: Set[str] = set(work)
    while work:
        fn = by_full[work.pop()]
        for name, _ in _calls_of(fn):
            bare = name.rsplit(".", 1)[-1]
            for callee in by_bare.get(bare, ()):
                if callee.full not in seen:
                    seen.add(callee.full)
                    work.append(callee.full)
    return seen


# ---------------------------------------------------------------------------
# Dataflow-lite helpers
# ---------------------------------------------------------------------------


def _is_device_call(name: str) -> bool:
    if name in DEVICE_EXCEPTIONS or name.startswith(DEVICE_EXCEPTION_PREFIXES):
        return False
    if name.rsplit(".", 1)[-1] in DEVICE_NAMES:
        return True
    return name.startswith(DEVICE_PREFIXES)


def _refs_tracked(node: ast.AST, tracked: Set[str]) -> bool:
    """Does ``node`` read a tracked tensor's *values*?  Shape / dtype /
    device reads, ``is`` / ``is not`` tests and the shape builtins
    (``len``, ``isinstance``, ...) stay on the host."""
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in STATIC_CALLS:
        return False
    if isinstance(node, ast.Name):
        return isinstance(node.ctx, ast.Load) and node.id in tracked
    return any(_refs_tracked(c, tracked) for c in ast.iter_child_nodes(node))


def _expr_is_device(node: ast.AST, tracked: Set[str]) -> bool:
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name and _is_device_call(name):
            return True
    return _refs_tracked(node, tracked)


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []                       # attribute / subscript targets: skip


def _tracked_names(fn: ast.AST, seed: Set[str]) -> Set[str]:
    """Fixpoint taint: names bound (directly or transitively) to device
    tensors inside ``fn``.  Loop targets and nested-function parameters
    are NOT tainted: iterating a container walks host structure."""
    tracked = set(seed)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if node.value is None:
                    continue
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            else:
                continue
            if _expr_is_device(value, tracked):
                for t in targets:
                    for name in _target_names(t):
                        if name not in tracked:
                            tracked.add(name)
                            changed = True
    return tracked


def _pos_params(node) -> List[str]:
    a = node.args
    return [p.arg for p in [*a.posonlyargs, *a.args]
            if p.arg not in ("self", "cls")]


def _fn_tracked(fn: FuncInfo) -> Set[str]:
    seed = {p for p in _pos_params(fn.node) if p in DEVICE_PARAMS}
    return _tracked_names(fn.node, seed)


def _receiver(call: ast.Call) -> Optional[ast.AST]:
    return call.func.value if isinstance(call.func, ast.Attribute) else None


# ---------------------------------------------------------------------------
# Pass 1: host-sync detector
# ---------------------------------------------------------------------------


def _host_sync_pass(files: Sequence[FileIndex],
                    reachable: Set[str]) -> List[Violation]:
    out: List[Violation] = []
    for fi in files:
        for fn in fi.funcs:
            if fn.full not in reachable:
                continue
            tracked = _fn_tracked(fn)
            for name, call in _calls_of(fn):
                bare = name.rsplit(".", 1)[-1]
                recv = _receiver(call)
                tag = None
                if name in ALWAYS_SYNC:
                    tag = (f"`{name}` blocks the host until the card "
                           "drains — one call per tick stalls the launch "
                           "queue behind the device")
                elif bare in SYNC_METHODS and "." in name:
                    tag = (f"`.{bare}()` synchronously waits for the "
                           "device (a copy to the host, or a stream / "
                           "event wait)")
                elif bare in HOST_METHODS and recv is not None and \
                        _refs_tracked(recv, tracked):
                    tag = (f"`.{bare}()` on a device tensor copies it to "
                           "the host and syncs the stream")
                elif name in HOST_NP and any(
                        _refs_tracked(a, tracked) for a in call.args):
                    tag = (f"`{name}` on a device tensor forces a "
                           "device→host copy inside the tick loop")
                elif name in HOST_CASTS and call.args and _refs_tracked(
                        call.args[0], tracked):
                    tag = (f"`{name}()` on a device tensor blocks until "
                           "the device catches up")
                if tag:
                    out.append(Violation(
                        "host-sync", fi.path, call.lineno,
                        f"{fn.qual}: {tag}"))
            for sub in ast.walk(fn.node):
                if isinstance(sub, (ast.If, ast.While, ast.IfExp)) and \
                        _refs_tracked(sub.test, tracked):
                    out.append(Violation(
                        "host-sync", fi.path, sub.lineno,
                        f"{fn.qual}: Python branch on a device tensor — "
                        "its truth value is read on the host, a sync; "
                        "branch on host state, or use torch.where"))
    return out


# ---------------------------------------------------------------------------
# Pass 1b: offload-sync detector
# ---------------------------------------------------------------------------


def _offload_sync_pass(files: Sequence[FileIndex],
                       cfg: AuditConfig) -> List[Violation]:
    """Any blocking host synchronisation inside the offloader's engaged
    window.  Unlike ``host-sync`` this does not gate on a device-tracked
    dataflow: the window functions exist solely to enqueue pool copies,
    so *every* wait there is a swap that should have stayed on the copy
    stream."""
    out: List[Violation] = []
    stall = ("serialises the swap behind the tick — enqueue the copies "
             "on the offloader's copy stream and let the compute stream "
             "wait on an event, so the transfer hides under compute")
    for fi in files:
        for fn in fi.funcs:
            if not any(_match_spec(fn, w) for w in cfg.offload_windows):
                continue
            for name, call in _calls_of(fn):
                bare = name.rsplit(".", 1)[-1]
                tag = None
                if name in ALWAYS_SYNC:
                    tag = f"`{name}` in the offload window {stall}"
                elif "." in name and (bare in SYNC_METHODS
                                      or bare in HOST_METHODS
                                      or bare in OFFLOAD_BARRIERS):
                    tag = f"`.{bare}()` in the offload window {stall}"
                elif name in HOST_NP:
                    tag = f"`{name}` in the offload window {stall}"
                if tag:
                    out.append(Violation("offload-sync", fi.path,
                                         call.lineno, f"{fn.qual}: {tag}"))
    return out


# ---------------------------------------------------------------------------
# Pass 1c: obs-hot-path detector
# ---------------------------------------------------------------------------


def _obs_pass(files: Sequence[FileIndex],
              reachable: Set[str]) -> List[Violation]:
    """Flight-recorder discipline (:mod:`repro_torch.obs`).  A recording
    call is any dotted call whose path routes through a recorder name (``self.recorder.span``, ``rec.link_send``).  In a reachable
    hot-path function, a recording call whose arguments reference a
    device-tracked value is flagged: reading it for the trace adds the
    very device→host sync the recorder's contract ("record only values
    the engine already holds on the host") forbids."""
    out: List[Violation] = []
    roots = set(OBS_ROOTS)

    def _is_obs(name: str) -> bool:
        parts = name.split(".")
        # the final component is the method; any earlier component being
        # a recorder name makes this a recording call
        return len(parts) >= 2 and any(p in roots for p in parts[:-1])

    for fi in files:
        for fn in fi.funcs:
            if fn.full not in reachable:
                continue
            tracked: Optional[Set[str]] = None
            for name, call in _calls_of(fn):
                if not _is_obs(name):
                    continue
                if tracked is None:     # computed once per function
                    tracked = _fn_tracked(fn)
                vals = [*call.args, *(k.value for k in call.keywords)]
                if any(_refs_tracked(a, tracked) for a in vals):
                    out.append(Violation(
                        "obs-hot-path", fi.path, call.lineno,
                        f"{fn.qual}: recording call `{name}` reads a "
                        "device tensor — record only host scalars the "
                        "engine already holds"))
    return out


# ---------------------------------------------------------------------------
# Pass 2: builds, compiles and captures in the hot path
# ---------------------------------------------------------------------------


def _retrace_pass(files: Sequence[FileIndex],
                  reachable: Set[str]) -> List[Violation]:
    out: List[Violation] = []
    for fi in files:
        for fn in fi.funcs:
            if fn.full not in reachable:
                continue
            for name, call in _calls_of(fn):
                if name in BUILD_CALLS or any(
                        name.endswith("." + b) for b in BUILD_CALLS):
                    out.append(Violation(
                        "retrace-jit", fi.path, call.lineno,
                        f"{fn.qual}: `{name}` inside the serve hot path — "
                        "a kernel build or load, a compile or a graph "
                        "capture per call; hoist it to construction, or "
                        "memoise it"))
    return out


# ---------------------------------------------------------------------------
# Pass 3: seed hygiene
# ---------------------------------------------------------------------------


def _seed_depth(node: ast.AST, env: Dict[str, Optional[int]]
                ) -> Optional[int]:
    """Depth of a seed expression in the ``token_seed(request_seed(seed,
    request_id), token_idx)`` chain: an int literal is 0,
    ``request_seed(s, r)`` is 1, ``token_seed(k, t)`` is depth(k)+1, a
    name looks up its single binding; anything else (parameters, helper
    results, casts) is unknown → None (never flagged)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return 0
    if isinstance(node, ast.Call):
        bare = (_dotted(node.func) or "").rsplit(".", 1)[-1]
        if bare == SEED_REQUEST:
            return 1
        if bare == SEED_TOKEN and node.args:
            inner = _seed_depth(node.args[0], env)
            return None if inner is None else inner + 1
        return None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    return None


def _prng_pass(files: Sequence[FileIndex]) -> List[Violation]:
    out: List[Violation] = []
    for fi in files:
        for fn in fi.funcs:
            # single-assignment bindings only: re-bound names drop out
            bound: Dict[str, List[ast.AST]] = {}
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    names = _target_names(node.targets[0])
                    if len(names) == 1:
                        bound.setdefault(names[0], []).append(node.value)
            env: Dict[str, Optional[int]] = {}
            for _ in range(3):      # chains of bound names, a few deep
                env = {k: _seed_depth(v[0], env) for k, v in bound.items()
                       if len(v) == 1}
            for name, call in _calls_of(fn):
                if name.rsplit(".", 1)[-1] != "manual_seed" or \
                        "." not in name or not call.args:
                    continue
                d = _seed_depth(call.args[0], env)
                if d is None or d >= 2:
                    continue
                arg = call.args[0]
                raw_token = isinstance(arg, ast.Call) and (
                    _dotted(arg.func) or "").endswith(SEED_TOKEN)
                if d == 0:
                    what = "raw seed — request_id AND token_idx dropped"
                elif raw_token:
                    what = ("token_seed over a raw seed — request_id "
                            "dropped")
                else:
                    what = "request_seed alone — token_idx dropped"
                out.append(Violation(
                    "prng-fold-drop", fi.path, call.lineno,
                    f"{fn.qual}: generator seeded by a {what}; derive "
                    "seeds as token_seed(request_seed(seed, request_id), "
                    "token_idx)"))
    return out


# ---------------------------------------------------------------------------
# Running the passes
# ---------------------------------------------------------------------------


def _apply_suppressions(violations: List[Violation],
                        files: Sequence[FileIndex],
                        strict: bool) -> List[Violation]:
    sup_by_file: Dict[str, List[Suppression]] = {
        fi.path: fi.suppressions for fi in files}
    kept: List[Violation] = []
    for v in violations:
        hit = None
        for s in sup_by_file.get(v.path, ()):
            if v.rule in s.rules and v.line in (s.line, s.target):
                hit = s
                break
        if hit is None:
            kept.append(v)
        else:
            hit.used = True
    if strict:
        for fi in files:
            for s in fi.suppressions:
                bad = s.rules - set(RULES)
                if bad:
                    kept.append(Violation(
                        "bad-suppression", s.path, s.line,
                        f"unknown rule(s) {sorted(bad)} — valid: "
                        f"{', '.join(RULES)}"))
                if not s.reason:
                    kept.append(Violation(
                        "bad-suppression", s.path, s.line,
                        "suppression without a written reason — every "
                        "exemption must explain itself: "
                        "# repro-torch-audit: allow(<rule>) — <why>"))
                elif not s.used and not bad:
                    kept.append(Violation(
                        "unused-suppression", s.path, s.line,
                        f"allow({', '.join(sorted(s.rules))}) suppresses "
                        "nothing on the line it covers — stale after a "
                        "fix; delete it"))
    return kept


def run_lint(paths: Sequence[Path], config: Optional[AuditConfig] = None,
             *, strict_suppressions: bool = False,
             rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Run every pass over ``paths`` (files or directories), apply
    suppressions, return surviving violations sorted by location."""
    cfg = config or AuditConfig()
    files, violations = index_paths([Path(p) for p in paths])
    reachable = reachable_functions(files, cfg.hot_roots)
    violations += _host_sync_pass(files, reachable)
    violations += _offload_sync_pass(files, cfg)
    violations += _obs_pass(files, reachable)
    violations += _retrace_pass(files, reachable)
    violations += _prng_pass(files)
    if rules:
        want = set(rules) | {"parse-error"}
        violations = [v for v in violations if v.rule in want]
    violations = _apply_suppressions(violations, files,
                                     strict_suppressions)
    return sorted(violations, key=lambda v: (v.path, v.line, v.rule))


def _default_root() -> Path:
    # the installed repro_torch package itself
    return Path(__file__).resolve().parents[1]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis for the port's serving core")
    ap.add_argument("paths", nargs="*", help="files or directories "
                    "(default: the installed repro_torch package)")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="require a written reason on every suppression "
                         "and flag suppressions that match nothing")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to report "
                         f"(all: {', '.join(RULES)})")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in RULES:
            print(r)
        return 0
    paths = [Path(p) for p in args.paths] or [_default_root()]
    for p in paths:
        if not p.exists():
            print(f"repro-torch-audit: no such path: {p}", file=sys.stderr)
            return 2
    rules = [r.strip() for r in args.rules.split(",")] if args.rules \
        else None
    violations = run_lint(paths, strict_suppressions=args.strict_suppressions,
                          rules=rules)
    for v in violations:
        print(v.format())
    n = len(violations)
    print(f"repro-torch-audit: {n} violation(s)" if n else
          "repro-torch-audit: clean")
    return 1 if violations else 0
