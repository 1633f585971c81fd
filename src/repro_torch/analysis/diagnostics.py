"""Unified diagnostics for the static-analysis subsystem.

The port's copy of the reference's diagnostics framework (it imports
nothing of the JAX package).  Every finding of the plan verifier
(``olap/analysis.py``) is a ``Diagnostic``: a stable code (``PLAN012``,
...), a severity, a location string, a human message, and a fix hint.
Codes are API — tests, baselines, and suppression files key on them, so
a code is never renamed or reused (retired codes stay in ``CODES`` with
a tombstone note).  The table keeps the reference's ``JIT0xx`` codes so
that both packages speak one code namespace; the port's hot-path
auditor (``analysis/jit_audit.py``) reports under them, each code meaning
in eager PyTorch what it means under JAX.

A **baseline** gates findings monotonically: only findings that are not
in it (matched by fingerprint) and whose code is not in its
``suppress_codes`` list fail, so existing debt is visible but does not
block, while every *new* finding does.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional

SEVERITIES = ("error", "warning", "info")

# The full code table.  A
# code's meaning is stable; only the message text may evolve.
CODES: Dict[str, str] = {
    # --- PLAN0xx: generic plan obligations (any rewrite) ---
    "PLAN001": "rewrite changed the plan's output schema",
    "PLAN002": "rewrite changed the scan (input table) of the plan",
    "PLAN003": "rewritten plan is structurally malformed",
    "PLAN004": "node reads a column unavailable in its input schema",
    # --- PLAN01x: pushdown obligations ---
    "PLAN010": "rewrite does not match the claimed rule's shape",
    "PLAN011": "filter pushed across a join (row identity changes)",
    "PLAN012": "filter pushed below the op producing a column it reads",
    "PLAN013": "opaque filter (no declared read set) pushed below a "
               "column-adding op",
    # --- PLAN02x: dedup obligations ---
    "PLAN020": "dedup rewrite changed more than the annotation",
    "PLAN021": "dedup on a derived/rewritten column (scatter invariant "
               "unprovable)",
    "PLAN022": "dedup annotation without duplicate input values",
    # --- PLAN03x: fusion obligations ---
    "PLAN030": "fused node is structurally invalid",
    "PLAN031": "fusion across differing templates (prompt/col/max_new/"
               "kind mismatch)",
    "PLAN032": "fused output columns disagree with the constituents'",
    "PLAN033": "fusion across a data dependency (an op reads a fused "
               "output)",
    "PLAN099": "unknown rewrite rule name",
    # --- JIT00x: jitted hot-path audit ---
    "JIT001": "host callback primitive inside a jitted hot-path function",
    "JIT002": "donated buffer was not usable (silent copy at dispatch)",
    "JIT003": "donated argument not rebound from the call result "
              "(read-after-donate hazard)",
    "JIT004": "weak-typed python scalar passed to a jitted function "
              "(promotion hazard)",
    "JIT005": "strong f32 scalar promotes a lower-precision operand to f32",
    "JIT006": "retrace hazard: more compiles than distinct input "
              "signatures",
    "JIT007": "decode-step FLOP count exceeds its budget",
    "JIT008": "decode-step memory traffic exceeds its budget",
    "JIT009": "collective op in a single-device decode step",
}


@dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding.

    ``location`` is a stable anchor, not a byte offset: a dotted rule
    site (``optimizer.pushdown``), a jit target (``engine._decode``),
    or a ``path:line`` when the finding is source-anchored.  The
    fingerprint hashes (code, location, message) so a finding stays
    recognized across unrelated edits.
    """
    code: str
    message: str
    location: str
    severity: str = "error"
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}; "
                             "register it in diagnostics.CODES")

    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.code}|{self.location}|{self.message}".encode())
        return h.hexdigest()[:16]

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


def _sev_rank(d: Diagnostic) -> int:
    return SEVERITIES.index(d.severity)


def sort_diagnostics(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    """Stable order for rendering and baselines: severity, code,
    location, message."""
    return sorted(diags, key=lambda d: (_sev_rank(d), d.code,
                                        d.location, d.message))


def render_text(diags: Iterable[Diagnostic]) -> str:
    diags = sort_diagnostics(diags)
    if not diags:
        return "no diagnostics"
    lines = []
    for d in diags:
        lines.append(f"{d.severity.upper():7s} {d.code} @ {d.location}: "
                     f"{d.message}")
        if d.hint:
            lines.append(f"        hint: {d.hint}")
    counts = summarize(diags)
    lines.append("-- " + ", ".join(f"{v} {k}(s)"
                                   for k, v in counts.items() if v))
    return "\n".join(lines)


def render_json(diags: Iterable[Diagnostic], *,
                extra: Optional[Dict] = None) -> str:
    diags = sort_diagnostics(diags)
    doc = {"diagnostics": [d.to_dict() for d in diags],
           "summary": summarize(diags)}
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=True)


def summarize(diags: Iterable[Diagnostic]) -> Dict[str, int]:
    counts = {s: 0 for s in SEVERITIES}
    for d in diags:
        counts[d.severity] += 1
    return counts


# ---------------------------------------------------------------------------
# baseline / suppression
# ---------------------------------------------------------------------------

@dataclass
class Baseline:
    """Known findings + code-level suppressions.

    ``fingerprints`` maps fingerprint -> the finding's dict (kept for
    human diffing of the baseline file); ``suppress_codes`` mutes a
    whole code (used for checks that are advisory on some platforms —
    each entry should carry a justification comment in the file via
    ``suppress_reasons``).
    """
    fingerprints: Dict[str, Dict] = field(default_factory=dict)
    suppress_codes: List[str] = field(default_factory=list)
    suppress_reasons: Dict[str, str] = field(default_factory=dict)

    def is_known(self, d: Diagnostic) -> bool:
        return (d.code in self.suppress_codes
                or d.fingerprint() in self.fingerprints)

    def new_findings(self, diags: Iterable[Diagnostic]) -> List[Diagnostic]:
        """Findings that should gate: not suppressed, not in the
        baseline, and not informational."""
        return [d for d in sort_diagnostics(diags)
                if d.severity != "info" and not self.is_known(d)]


def load_baseline(path: str) -> Baseline:
    with open(path) as f:
        doc = json.load(f)
    return Baseline(fingerprints=doc.get("fingerprints", {}),
                    suppress_codes=list(doc.get("suppress_codes", [])),
                    suppress_reasons=dict(doc.get("suppress_reasons", {})))


def save_baseline(path: str, diags: Iterable[Diagnostic],
                  *, suppress_codes: Optional[List[str]] = None,
                  suppress_reasons: Optional[Dict[str, str]] = None) -> None:
    doc = {
        "suppress_codes": sorted(suppress_codes or []),
        "suppress_reasons": suppress_reasons or {},
        "fingerprints": {d.fingerprint(): d.to_dict()
                         for d in sort_diagnostics(diags)
                         if d.severity != "info"},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
