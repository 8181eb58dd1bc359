"""``python -m mpi_k_selection_tpu_torch.analysis`` driver, with the JAX
package's flags.

Exit codes: 0 clean (or everything suppressed), 1 unsuppressed findings,
2 usage error. The tier-1 gate (tests/test_torch_analysis.py) runs the
same engine in-process over the port and asserts exit code 0.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_k_selection_tpu_torch.analysis",
        description=(
            "Static analysis of the PyTorch port: AST rules (KSLxxx) and "
            "torch contract checks (KSCxxx). Rule catalog: "
            "docs/TORCH_ANALYSIS.md."
        ),
    )
    p.add_argument("paths", nargs="*", default=["."], help="files/directories to scan")
    p.add_argument("--json", action="store_true", help="emit the JSON report")
    p.add_argument("--output", default=None, help="also write the JSON report here")
    p.add_argument(
        "--select", default=None,
        help="comma-separated rule-id prefixes to run (e.g. KSL001,KSC)",
    )
    p.add_argument(
        "--ignore", default=None,
        help="comma-separated rule-id prefixes to skip",
    )
    p.add_argument(
        "--no-contracts", action="store_true",
        help="skip the torch contract checks (their CPU halves, on the plain versions)",
    )
    p.add_argument(
        "--concurrency-report", default=None, metavar="PATH",
        help=(
            "also write the thread-reachability call graph, the static "
            "lock-order graph (KSL016's), and the per-class guard "
            "inference as JSON to PATH"
        ),
    )
    p.add_argument(
        "--lifecycle-report", default=None, metavar="PATH",
        help=(
            "also write the resource-ownership graph (KSL019-021's "
            "acquire sites, release sites, escape edges, the owner-site "
            "registry, and the `# ksel: owner[...]` annotation ledger) "
            "as JSON to PATH"
        ),
    )
    p.add_argument(
        "--placement", action="store_true",
        help=(
            "run only the device-placement pass (KSL022-024 dataflow "
            "rules plus the KSC105 static<->runtime census contract "
            "unless --no-contracts)"
        ),
    )
    p.add_argument(
        "--placement-report", default=None, metavar="PATH",
        help=(
            "also write the placement census (the abstract lattice, "
            "per-module dispatch and crossing sites, the sanctioned-"
            "transfer registry, and the `# ksel: placed-on[...]` "
            "annotation ledger) as JSON to PATH"
        ),
    )
    p.add_argument(
        "--verbose", action="store_true",
        help="show suppressed findings in text output too",
    )
    p.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpi_k_selection_tpu_torch.analysis import (
        CONTRACT_CHECKS,
        all_rules,
        render_json,
        render_text,
        run_analysis,
    )

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid}  {rule.title}")
        for check in CONTRACT_CHECKS:
            print(f"{check.id}  {check.title}")
        return 0

    select = args.select.split(",") if args.select else None
    ignore = args.ignore.split(",") if args.ignore else None
    if args.placement:
        select = (select or []) + ["KSL022", "KSL023", "KSL024", "KSC105"]
    try:
        report = run_analysis(
            args.paths,
            select=select,
            ignore=ignore,
            contracts=not args.no_contracts,
        )
    except (OSError, RuntimeError) as e:
        print(f"analysis: error: {e}", file=sys.stderr)
        return 2
    if args.concurrency_report:
        import json

        from mpi_k_selection_tpu_torch.analysis.concurrency import (
            build_concurrency_report,
        )

        with open(args.concurrency_report, "w") as fh:
            json.dump(
                build_concurrency_report(args.paths, mods=report.modules),
                fh, indent=2, sort_keys=True,
            )
    if args.lifecycle_report:
        import json

        from mpi_k_selection_tpu_torch.analysis.lifecycle import (
            build_lifecycle_report,
        )

        with open(args.lifecycle_report, "w") as fh:
            json.dump(
                build_lifecycle_report(args.paths, mods=report.modules),
                fh, indent=2, sort_keys=True,
            )
    if args.placement_report:
        import json

        from mpi_k_selection_tpu_torch.analysis.placement import (
            build_placement_report,
        )

        with open(args.placement_report, "w") as fh:
            json.dump(
                build_placement_report(args.paths, mods=report.modules),
                fh, indent=2, sort_keys=True,
            )
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(render_json(report))
    print(render_json(report) if args.json else render_text(report, verbose=args.verbose))
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
