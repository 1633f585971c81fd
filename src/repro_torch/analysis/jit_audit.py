"""Auditor of the serving engine's hot path.

The port's counterpart of the reference's ``analysis/jit_audit.py``.
The engine's throughput depends on the tick loop staying on the device:
no host round trip inside a step, slot state updated in place rather
than copied per call, no kernel built inside the loop.  Nothing in the
code enforces that: a change can add a host sync to ``_decode``, a copy
of the whole KV pool per step, or an ``nvcc`` run inside the hot path,
and every test still passes, just slower.  ``audit_engine(engine)``
drives a scripted workload through the engine's real ``generate`` path
with recorders around every target of ``Engine.jit_targets()``
(``_insert``, ``_decode``, ``_seed`` when paged, and the ``_prefill`` /
``_prefill_from`` bucket ladders), then reports, under the reference's
codes:

  JIT001  an op that makes the host wait for the device while a target
          runs (``.item()``, ``bool()``, ``nonzero``, ``masked_select``,
          ``unique``, a device-to-host copy), seen by a
          ``TorchDispatchMode``; on the card each target also runs under
          ``torch.cuda.set_sync_debug_mode("warn")`` and its warnings count
  JIT002  a target that updates slot state returning a state whose
          storage is not the engine's (a copy of the KV pool or the
          recurrent state per call; the port writes it in place)
  JIT003  a call site of a donating target that does not rebind the
          donated argument (AST check over the engine source)
  JIT004  a target argument that is a numpy array, a sequence of Python
          numbers, a Python float or a tensor off the engine's device: a
          host-to-device copy per call.  Python ints are not flagged:
          they are the lengths and offsets the eager ops take as
          arguments (``prefill_from``'s prefix length), what a static
          argument is to a jit, and a tensor there would cost a sync
  JIT005  an op with a bf16/f16 tensor operand and an f32 result whose
          only f32 input holds at most one element (explicit casts
          excepted): a strong f32 scalar promoting low-precision math
  JIT006  a kernel library built or loaded (``kernels/build.py``
          ``load``) after a target's first call: ``nvcc`` inside the hot
          path, the port's only run-time compile
  JIT007/8/9  the decode step's FLOPs and bytes against 2·N_active·slots
          and params + 2 x slot state, and collectives on a
          single-device engine.  FLOPs are PyTorch's ``FlopCounterMode``
          over the aten ops plus each kernel launch's own count
          (``kernels/ops.py`` ``launch_flops``), bytes every aten op's
          inputs and outputs plus each launch's (``launch_bytes``): a
          ``ctypes`` launch is invisible to any dispatch mode.

The port compiles nothing at run time and there is no jaxpr: every
check watches the ops that the workload's calls dispatch.
"""
from __future__ import annotations

import ast
import inspect
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.compressed import ShardedTensor, param_bytes
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.launch import roofline
from repro_torch.tree import flatten_with_path

# ops that return a value to the host, so the host waits for the device
SYNC_OPS = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::nonzero",
            "aten::masked_select", "aten::equal", "aten::unique_dim",
            "aten::unique_consecutive", "aten::_unique", "aten::_unique2")
COPY_OPS = ("aten::_to_copy", "aten::copy_")
# what torch.cuda.set_sync_debug_mode("warn") says of a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
CAST_OPS = ("aten::_to_copy", "aten::copy_", "aten::clone", "aten::to")
LOW_PRECISION = (torch.bfloat16, torch.float16)

# targets that update the engine's slot state (their result, or its last
# element, is the state)
STATE_TARGETS = ("_insert", "_decode", "_seed")


# ---------------------------------------------------------------------------
# what a target's ops do
# ---------------------------------------------------------------------------

def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, ShardedTensor):          # a mesh engine's k/v: its pieces
        for p in tree.pieces:
            yield from _tensors(p)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpLog:
    """What the ops dispatched while one target ran did."""
    syncs: List[str] = field(default_factory=list)
    promotions: List[str] = field(default_factory=list)
    collectives: Dict[str, float] = field(default_factory=dict)
    bytes: float = 0.0


class _Watch(TorchDispatchMode):
    """Records syncs, low-precision promotions, collectives and bytes of
    every aten op it sees; ``device`` is the engine's."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.log = OpLog()

    def _on_device(self, t) -> bool:
        return t.device.type == self.device.type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        name = schema.name
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if name in SYNC_OPS or name.startswith("aten::unique"):
            if any(self._on_device(t) for t in ins):
                self.log.syncs.append(name)
        elif name in COPY_OPS and self.device.type != "cpu":
            src = ins[1] if name == "aten::copy_" else ins[0]
            dst = ins[0] if name == "aten::copy_" else (outs[0] if outs else None)
            if dst is not None and self._on_device(src) and dst.device.type == "cpu":
                self.log.syncs.append(f"{name} (device to host)")
        if func.namespace in COLLECTIVE_NAMESPACES:
            self.log.collectives[name] = (self.log.collectives.get(name, 0.0)
                                          + sum(_nbytes(t) for t in ins))
        if (name not in CAST_OPS and any(t.dtype in LOW_PRECISION for t in ins)
                and any(t.dtype == torch.float32 for t in outs)):
            f32 = [t for t in ins if t.dtype == torch.float32]
            if f32 and all(t.numel() <= 1 for t in f32):
                self.log.promotions.append(name)
        self.log.bytes += _op_bytes(schema, ins, outs)
        return out


def _op_bytes(schema, ins, outs) -> float:
    """Bytes one op moves: each input read and each output written once; a
    view moves none; an op that writes into an input moves that input's
    elements it writes, taken as the other inputs' size (a scatter), or
    reads and writes it whole (an elementwise op in place)."""
    ret = schema.returns[0].alias_info if schema.returns else None
    if ret is not None and not ret.is_write:
        return 0.0                                   # a view
    mutated = [a.alias_info is not None and a.alias_info.is_write for a in schema.arguments]
    if not any(mutated):
        return float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
    written = {id(t) for t in outs}
    rest = sum(_nbytes(t) for t in ins if id(t) not in written)
    dst = sum(_nbytes(t) for t in outs)
    return float(rest + (rest if rest else 2 * dst))


# ---------------------------------------------------------------------------
# recorders around the engine's targets
# ---------------------------------------------------------------------------

def _leaf_sig(x) -> Tuple:
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("numpy", tuple(x.shape), str(x.dtype))
    return ("py", type(x).__name__)


def call_signature(args: Tuple, kwargs: Dict) -> Tuple:
    flat = flatten_with_path((list(args), kwargs))
    return tuple((tuple(map(str, p)), _leaf_sig(x)) for p, x in flat)


def host_arguments(args: Tuple, kwargs: Dict, device: torch.device) -> List[str]:
    """The arguments of a call that live on the host (JIT004): numpy
    arrays, sequences of Python numbers, Python floats, tensors off
    ``device``; each as 'path: what'."""
    found = []

    def walk(x, path):
        if torch.is_tensor(x):
            if x.device.type != device.type:
                found.append(f"{path}: a tensor on {x.device}")
        elif isinstance(x, np.ndarray):
            found.append(f"{path}: a numpy array {x.dtype}{list(x.shape)}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            if x and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in x):
                found.append(f"{path}: a {type(x).__name__} of Python numbers")
            else:
                for i, v in enumerate(x):
                    walk(v, f"{path}[{i}]")
        elif isinstance(x, float):
            found.append(f"{path}: a Python float")

    for i, a in enumerate(args):
        walk(a, f"argument {i}")
    for k, v in kwargs.items():
        walk(v, k)
    return found


def _storages(state) -> Dict[Tuple, int]:
    """Each state tensor's storage by path (a sharded leaf's pieces under
    the leaf's path and their index)."""
    out = {}
    for p, leaf in flatten_with_path(state):
        if torch.is_tensor(leaf):
            out[tuple(p)] = leaf.untyped_storage().data_ptr()
        elif isinstance(leaf, ShardedTensor):
            for i, t in enumerate(_tensors(leaf)):
                out[tuple(p) + (i,)] = t.untyped_storage().data_ptr()
    return out


class JitCallRecorder:
    """Transparent proxy around one engine target: records its calls'
    signatures and what each call's ops did."""

    def __init__(self, name: str, fn: Callable, engine, budget: bool = False):
        self.name = name
        self.fn = fn
        self.engine = engine
        self.budget = budget
        self.calls = 0
        self.signatures: set = set()
        self.loads: List[Tuple[int, str]] = []    # (call number, library)
        self.syncs: List[str] = []
        self.promotions: List[str] = []
        self.host_args: List[str] = []
        self.copied: List[str] = []               # state leaves not updated in place
        self.collectives: Dict[str, float] = {}
        self.step_flops: List[float] = []
        self.step_bytes: List[float] = []

    def __call__(self, *args, **kwargs):
        eng = self.engine
        self.calls += 1
        self.signatures.add(call_signature(args, kwargs))
        self.host_args.extend(h for h in host_arguments(args, kwargs, eng.device)
                              if h not in self.host_args)
        before = (_storages(eng._slot_state)
                  if self.name in STATE_TARGETS and eng._slot_state is not None else None)
        k_flops, k_bytes = sum(kops.launch_flops.values()), sum(kops.launch_bytes.values())
        on_card = eng.device.type == "cuda"
        flop_mode = FlopCounterMode(display=False) if self.budget else None
        prev = torch.cuda.get_sync_debug_mode() if on_card else None
        _LOADS.append(self)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    with flop_mode or nullcontext(), _Watch(eng.device) as watch:
                        out = self.fn(*args, **kwargs)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(prev)
        finally:
            _LOADS.pop()
        log = watch.log
        self.syncs.extend(s for s in log.syncs if s not in self.syncs)
        self.syncs.extend(f"sync debug mode: {str(w.message).splitlines()[0][:120]}"
                          for w in caught if SYNC_WARNING in str(w.message))
        self.promotions.extend(p for p in log.promotions if p not in self.promotions)
        for k, v in log.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v
        if before is not None:
            state = out[-1] if isinstance(out, tuple) else out
            after = _storages(state)
            self.copied.extend(".".join(map(str, p)) for p, ptr in after.items()
                               if p in before and before[p] != ptr
                               and ".".join(map(str, p)) not in self.copied)
        if flop_mode is not None:
            self.step_flops.append(flop_mode.get_total_flops()
                                   + sum(kops.launch_flops.values()) - k_flops)
            self.step_bytes.append(log.bytes + sum(kops.launch_bytes.values()) - k_bytes)
        return out


# the recorder whose call is running, innermost last: a library load lands there
_LOADS: List[JitCallRecorder] = []


def _watching_load(load):
    def wrapped(name: str):
        fresh = name not in build._LIBS
        lib = load(name)
        if fresh and _LOADS:
            rec = _LOADS[-1]
            rec.loads.append((rec.calls, name))
        return lib
    return wrapped


class _Ladder:
    """The engine's one ``_prefill`` (or ``_prefill_from``) method seen as
    the reference's bucket ladder: each call goes to the recorder named
    after its token width, ``_prefill[b]``."""

    def __init__(self, name: str, fn: Callable, recs: Dict[str, JitCallRecorder], engine,
                 tok_arg: int):
        self.name, self.fn, self.recs, self.engine, self.tok_arg = (name, fn, recs, engine,
                                                                    tok_arg)

    def __call__(self, *args, **kwargs):
        key = f"{self.name}[{args[self.tok_arg].shape[1]}]"
        if key not in self.recs:
            self.recs[key] = JitCallRecorder(key, self.fn, self.engine)
        return self.recs[key](*args, **kwargs)


_MISSING = object()


def _install(engine) -> Tuple[Dict[str, JitCallRecorder], Dict[str, Any]]:
    """Recorders around every target of ``engine.jit_targets()``; returns
    them by stable name and the attributes they shadow."""
    targets = engine.jit_targets()
    attrs = sorted({n.split("[")[0] for n in targets})
    saved = {a: engine.__dict__.get(a, _MISSING) for a in attrs}
    recs: Dict[str, JitCallRecorder] = {}
    for a in attrs:
        fn = getattr(engine, a)
        if a == "_prefill":
            setattr(engine, a, _Ladder(a, fn, recs, engine, 0))
        elif a == "_prefill_from":
            setattr(engine, a, _Ladder(a, fn, recs, engine, 1))
        else:
            recs[a] = JitCallRecorder(a, fn, engine, budget=a == "_decode")
            setattr(engine, a, recs[a])
    return recs, saved


def _restore(engine, saved: Dict[str, Any]) -> None:
    for a, v in saved.items():
        if v is _MISSING:
            engine.__dict__.pop(a, None)
        else:
            setattr(engine, a, v)


# ---------------------------------------------------------------------------
# individual checks
# ---------------------------------------------------------------------------

def audit_syncs(rec: JitCallRecorder) -> List[Diagnostic]:
    return [Diagnostic(
        "JIT001", f"{s} while the target runs: the host waits for the device on "
                  "every call", f"engine.{rec.name}",
        hint="keep the value on the device (torch.where, index arithmetic) or read "
             "it back once per tick, outside the step") for s in rec.syncs]


def audit_state_copies(rec: JitCallRecorder) -> List[Diagnostic]:
    if not rec.copied:
        return []
    return [Diagnostic(
        "JIT002", f"returns slot state whose storage is not the engine's "
                  f"({', '.join(rec.copied[:4])}{', ...' if len(rec.copied) > 4 else ''}): "
                  "a copy of the state on every call", f"engine.{rec.name}",
        hint="write the state in place (index_copy_, index_put_) and return the "
             "same tensors")]


def audit_host_args(rec: JitCallRecorder) -> List[Diagnostic]:
    return [Diagnostic(
        "JIT004", f"{h}: copied to the device on every call", f"engine.{rec.name}",
        severity="warning",
        hint="move it to the device once, outside the target (Engine._dev)")
        for h in rec.host_args]


def audit_promotions(rec: JitCallRecorder) -> List[Diagnostic]:
    return [Diagnostic(
        "JIT005", f"{p}: a one-element f32 tensor promotes a low-precision operand "
                  "to f32", f"engine.{rec.name}", severity="warning",
        hint="use a Python float or a 0-dim tensor, or cast the constant to the "
             "operand dtype") for p in rec.promotions]


def audit_retrace(rec: JitCallRecorder) -> List[Diagnostic]:
    late = [(n, lib) for n, lib in rec.loads if n > 1]
    if not late:
        return []
    return [Diagnostic(
        "JIT006", f"kernel library {', '.join(sorted({lib for _, lib in late}))} built or "
                  f"loaded in call {', '.join(str(n) for n, _ in late)} of "
                  f"{rec.calls}: a build inside the hot path", f"engine.{rec.name}",
        hint="build the kernels before serving (kernels.build.build_all)")]


def audit_donation_sites(source: str, donations: Dict[str, Tuple[int, ...]],
                         location: str) -> List[Diagnostic]:
    """AST check: every call of a donating jitted function must rebind
    its donated argument from the call's result in the same statement.
    Reading the old binding after the call is a use-after-free on
    accelerators (and a silent copy on others)."""
    out = []
    tree = ast.parse(source)
    parents: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        fname = None
        if isinstance(call.func, ast.Attribute):
            fname = call.func.attr
        elif isinstance(call.func, ast.Name):
            fname = call.func.id
        if fname not in donations:
            continue
        stmt: ast.AST = call
        while stmt in parents and not isinstance(stmt, ast.stmt):
            stmt = parents[stmt]
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets.extend(t.elts if isinstance(
                    t, (ast.Tuple, ast.List)) else [t])
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        # unparse, not ast.dump: the donated arg is a Load and the
        # assignment target a Store — textual identity is the question
        target_dumps = {ast.unparse(t) for t in targets}
        for pos in donations[fname]:
            if pos >= len(call.args):
                continue
            arg = call.args[pos]
            if not isinstance(arg, (ast.Name, ast.Attribute)):
                continue      # temporaries cannot be read again
            if ast.unparse(arg) not in target_dumps:
                out.append(Diagnostic(
                    "JIT003",
                    f"{fname}() donates argument {pos} "
                    f"({ast.unparse(arg)}) but the call site does not "
                    "rebind it from the result",
                    f"{location}:{call.lineno}",
                    hint="write `x = fn(x, ...)` (or unpack into it) "
                         "so the donated binding can never be read "
                         "after the transfer"))
    return out


def audit_decode_budget(engine, rec: JitCallRecorder, *, flop_factor: float = 4.0,
                        bytes_factor: float = 16.0
                        ) -> Tuple[List[Diagnostic], Optional[Dict]]:
    """The decode step's measured FLOPs, bytes and collectives (the most
    of any audited step) against analytic budgets: 2·N_active per row for
    compute, params + 2x slot state for traffic, no collective on one
    device.

    ``bytes_factor`` is loose on purpose: every aten op's operands count
    whole (a gather from the KV pool counts the pool), as ``cost_analysis``
    counts every buffer access for the reference, while the regression
    this catches (re-touching the whole cache per token, a prefill inside
    the step) multiplies traffic by O(seq_len)."""
    if not rec.step_flops:
        return [], None
    spec = roofline.ShapeSpec("audit_decode", seq_len=engine.max_len,
                              global_batch=engine.slots, kind="decode")
    expected_flops = roofline.model_flops(engine.cfg, spec)
    params = param_bytes(engine.params)
    state = sum(_nbytes(t) for t in _tensors(engine._slot_state or {}))
    expected_bytes = params + 2 * state
    flops, nbytes = max(rec.step_flops), max(rec.step_bytes)
    coll = sum(rec.collectives.values())
    detail = {"flops": flops, "expected_flops": expected_flops, "bytes": nbytes,
              "expected_bytes": expected_bytes, "param_bytes": params,
              "state_bytes": state, "steps": len(rec.step_flops),
              "coll_bytes": coll, "coll_detail": dict(rec.collectives)}
    diags = []
    if expected_flops and flops > flop_factor * expected_flops:
        diags.append(Diagnostic(
            "JIT007", f"decode step costs {flops:.3g} FLOPs vs ~{expected_flops:.3g} for "
                      f"2·N_active·slots (>{flop_factor:g}x budget)", "engine._decode",
            severity="warning",
            hint="look for recomputation over the whole cache or an accidental prefill "
                 "inside the step"))
    if expected_bytes and nbytes > bytes_factor * expected_bytes:
        diags.append(Diagnostic(
            "JIT008", f"decode step moves {nbytes:.3g} bytes vs ~{expected_bytes:.3g} for "
                      f"params + 2x slot state (>{bytes_factor:g}x budget)",
            "engine._decode", severity="warning",
            hint="the step should read params once and touch slot state, nothing "
                 "larger"))
    if coll > 0 and getattr(engine, "mesh", None) is None:
        diags.append(Diagnostic(
            "JIT009", f"decode step contains collectives ({rec.collectives}) on a "
                      "single-device engine", "engine._decode"))
    return diags, detail


# ---------------------------------------------------------------------------
# the engine audit
# ---------------------------------------------------------------------------

@dataclass
class AuditReport:
    diagnostics: List[Diagnostic]
    cache_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)
    budget: Optional[Dict] = None

    def to_dict(self) -> Dict:
        return {"diagnostics": [d.to_dict() for d in self.diagnostics],
                "cache_stats": self.cache_stats, "budget": self.budget}


def default_workload(engine) -> List[str]:
    """Deterministic prompts exercising every bucket of the engine's
    ladder plus partial-batch admission (so retrace detection sees the
    admission widths real traffic produces)."""
    prompts = [f"row {i} value v{i}" for i in range(2 * engine.slots + 1)]
    if len(engine.buckets) > 1:
        pad = "x" * (engine.buckets[0] + 2)
        prompts += [f"{pad} long row {i}" for i in range(2)]
    return prompts


# donated positions of the engine's targets, for the AST check.  The
# port's targets take no slot state argument: they read the engine's and
# write it in place (index_copy_), so no call site passes a buffer that
# it may not read again, and ``_seed``'s result is discarded by design.
# All three are in place; JIT002 guards that.
ENGINE_DONATIONS: Dict[str, Tuple[int, ...]] = {
    "_insert": (),
    "_decode": (),
    "_seed": (),
}


def audit_engine(engine, prompts: Optional[List[str]] = None, *,
                 max_new: int = 4, flop_factor: float = 4.0,
                 bytes_factor: float = 16.0,
                 source: Optional[str] = None) -> AuditReport:
    """Run the full hot-path audit against a live engine.

    Drives ``prompts`` (default: a bucket-covering scripted workload)
    through ``generate``, plus a prefix-seeded pass when the engine has a
    prefix cache, so the ``_prefill_from`` ladder (and ``_seed`` when
    paged) is exercised, then applies every check to the recorded
    targets.  A template prefix's one-time prefill is recorded under its
    own length, ``_prefill[<tokens>]``.  The engine's targets are restored afterwards, whatever
    happens.  ``source`` overrides the audited call-site source text
    (tests use this to prove JIT003 fires)."""
    if prompts is None:
        prompts = default_workload(engine)
    recs, saved = _install(engine)
    load = build.load
    build.load = _watching_load(load)
    try:
        engine.generate(list(prompts), max_new=max_new)
        if engine.prefix_cache is not None:
            # a template of at least one whole KV block, so that a paged
            # engine seeds it into shared blocks (``_seed``)
            tpl = "audit template: " + "." * engine._block_size
            engine.generate([f"{tpl}row {i}" for i in range(engine.slots)],
                            max_new=max_new, prefix=tpl)
    finally:
        build.load = load
        _restore(engine, saved)

    diags: List[Diagnostic] = []
    cache_stats: Dict[str, Dict[str, int]] = {}
    for name in sorted(recs):
        rec = recs[name]
        if not rec.calls:
            continue
        cache_stats[name] = {"calls": rec.calls, "signatures": len(rec.signatures),
                             "compiles": len(rec.loads)}
        for check in (audit_syncs, audit_state_copies, audit_host_args,
                      audit_promotions, audit_retrace):
            diags.extend(check(rec))

    if source is None:
        from repro_torch.serving import engine as engine_module
        source = inspect.getsource(engine_module)
    diags.extend(audit_donation_sites(source, ENGINE_DONATIONS, "serving/engine.py"))
    budget_diags, budget = audit_decode_budget(
        engine, recs["_decode"], flop_factor=flop_factor, bytes_factor=bytes_factor)
    diags.extend(budget_diags)
    return AuditReport(diags, cache_stats, budget)
