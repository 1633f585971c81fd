"""Static analysis: unified diagnostics (the plan verifier that emits
them lives in ``repro_torch.olap.analysis``)."""
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
