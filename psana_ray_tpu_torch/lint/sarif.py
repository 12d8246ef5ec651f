"""SARIF 2.1.0 output for the lint CLI.

CI annotates PRs from SARIF (GitHub code scanning ingests it
natively); ``python -m psana_ray_tpu_torch.lint --sarif`` emits one run with
one result per finding:

- ``ruleId`` = checker name, with the checker's description in the
  tool's rule table (``tool.driver.rules``);
- ``locations[0]`` = repo-relative uri + 1-based startLine;
- ``message.text`` = the finding message; the fix hint rides in the
  result ``properties.hint`` bag (SARIF has no first-class hint field)
  so :func:`findings_from_sarif` can round-trip losslessly — the shape
  the schema round-trip test pins.

Zero findings still emits a valid document (empty ``results``) so a CI
uploader never special-cases the clean run.
"""

from __future__ import annotations

from typing import List

from psana_ray_tpu_torch.lint.core import Finding, LintResult, REGISTRY

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
TOOL_NAME = "psana-ray-tpu-lint"


def to_sarif(result: LintResult) -> dict:
    """The SARIF 2.1.0 document for one lint run."""
    rule_ids = sorted(
        set(result.checkers_run)
        | {f.checker for f in result.findings}
    )
    rules = []
    for rid in rule_ids:
        checker = REGISTRY.get(rid)
        desc = checker.description if checker is not None else rid
        rules.append(
            {
                "id": rid,
                "shortDescription": {"text": desc},
            }
        )
    results = []
    for f in result.findings:
        results.append(
            {
                "ruleId": f.checker,
                "level": "error",
                "message": {"text": f.message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f.path,
                                "uriBaseId": "SRCROOT",
                            },
                            "region": {"startLine": max(1, f.line)},
                        }
                    }
                ],
                "properties": {"hint": f.hint, "line": f.line},
            }
        )
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "rules": rules,
                    }
                },
                "results": results,
                "properties": {
                    "filesScanned": result.files_scanned,
                    "checkersRun": list(result.checkers_run),
                    "durationS": round(result.duration_s, 3),
                    "clean": result.ok,
                },
            }
        ],
    }


def findings_from_sarif(doc: dict) -> List[Finding]:
    """Reconstruct :class:`Finding` objects from a document produced by
    :func:`to_sarif` — the round-trip contract the tests pin."""
    out: List[Finding] = []
    for run in doc.get("runs", []):
        for res in run.get("results", []):
            loc = res["locations"][0]["physicalLocation"]
            props = res.get("properties", {})
            out.append(
                Finding(
                    checker=res["ruleId"],
                    path=loc["artifactLocation"]["uri"],
                    # properties.line preserves the raw value (region
                    # startLine clamps 0 -> 1 for schema validity)
                    line=int(props.get("line", loc["region"]["startLine"])),
                    message=res["message"]["text"],
                    hint=props.get("hint", ""),
                )
            )
    return out
