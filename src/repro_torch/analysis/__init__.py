"""Static analysis: unified diagnostics, emitted by the plan verifier
(``repro_torch.olap.analysis``) and the serving engine's hot-path auditor
(``analysis/jit_audit.py``)."""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    Baseline,
    Diagnostic,
    load_baseline,
    render_json,
    render_text,
    save_baseline,
    sort_diagnostics,
    summarize,
)
