"""Report rendering: human text and machine JSON, sharing one Report
(the JAX package's ``analysis/reporters.py``; the JSON keys are its keys).
Suppressed findings stay in the JSON report with their justification, so
it doubles as the suppression ledger.
"""

from __future__ import annotations

import json

from mpi_k_selection_tpu_torch.analysis.core import Report


def render_text(report: Report, *, verbose: bool = False) -> str:
    lines: list[str] = []
    shown = report.findings if verbose else report.unsuppressed
    for f in shown:
        lines.append(f.render())
    for d in report.dead_suppressions:
        lines.append(
            f"{d['path']}:{d['line']}: stale noqa[{d['rule']}] "
            f"({d['scope']}-scope) — the rule no longer fires here; "
            "drop the suppression"
        )
    nsup = len(report.findings) - len(report.unsuppressed)
    summary = (
        f"{len(report.unsuppressed)} finding(s) "
        f"({nsup} suppressed, {len(report.dead_suppressions)} stale "
        f"suppression(s)) in {len(report.files)} file(s); "
        f"checks: {', '.join(report.checks_run)}"
    )
    lines.append(summary)
    return "\n".join(lines)


def render_json(report: Report) -> str:
    from mpi_k_selection_tpu_torch.analysis.core import all_rules

    return json.dumps(
        {
            "findings": [f.to_dict() for f in report.findings],
            "unsuppressed": len(report.unsuppressed),
            "suppressed": len(report.findings) - len(report.unsuppressed),
            "files_scanned": report.files,
            "checks_run": report.checks_run,
            "dead_suppressions": report.dead_suppressions,
            "rules": {
                rid: {"title": r.title, "rationale": r.rationale}
                for rid, r in sorted(all_rules().items())
            },
            "exit_code": report.exit_code,
        },
        indent=2,
    )
