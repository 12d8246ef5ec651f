"""Registry entry: the ``protocol-model`` checker.

Two layers, both anchored to the extracted dialogue so the checker arms
exactly like ``protocol-dialogue`` does (opcode constants + a dispatch
table in scope, nothing repo-specific hard-coded):

1. the drift gate (:mod:`.drift`) — every scan.  On fixture-sized
   protocols only the code->model direction runs; when the real
   transport is in scope the model->code direction runs too.
2. bounded exploration — only when the real transport is in scope, on
   the quick profile so the registry entry stays well inside the lint
   budgets (the full profile belongs to ``--model`` and chip_smoke.py).  A
   counterexample on the live tree is a finding carrying the rendered
   trace; so is a truncated (non-exhausted) run, because a truncated
   "zero counterexamples" claim is not a claim.
"""

from __future__ import annotations

import os

from ..core import Checker, Finding, register
from ..flow.protocol import extract_dialogue
from . import all_models
from .core import explore, render_report, render_trace
from .drift import check_drift

# The registry run explores the quick profile; it must stay a small
# fraction of the full-registry budget (25s) and of the --changed budget
# (4s); the quick profile of the whole fleet takes milliseconds.
REGISTRY_BUDGET_S = 3.0

_TRANSPORT_RELS = (
    "psana_ray_tpu_torch/transport/evloop.py",
    "psana_ray_tpu_torch/transport/tcp.py",
)


def run_model_report(profile="full"):
    """The ``--model`` entry point: full-profile exploration of
    every model plus the drift gate over the protocol companions.

    Returns ``(results, drift)``: a list of ExploreResult and a list of
    (message, hint) drift findings."""

    from ..core import ProjectIndex, PROTOCOL_COMPANIONS, REPO_ROOT

    models = all_models()
    index = ProjectIndex(
        [os.path.join(REPO_ROOT, rel) for rel in PROTOCOL_COMPANIONS])
    d = extract_dialogue(index)
    drift = [] if d is None else list(check_drift(d, models, full=True))
    if d is None:
        drift.append((
            "the protocol companions no longer yield a dialogue "
            "reconstruction — the drift gate cannot anchor the models",
            "restore the opcode constants + dispatch table pair in "
            "transport/tcp.py + transport/evloop.py",
        ))
    results = [explore(m, profile=profile) for m in models]
    return results, drift


def main_model(json_mode=False) -> int:
    """``python -m psana_ray_tpu_torch.lint --model``: exhaust the bounded
    configs, print the report (or JSON), exit 1 on any counterexample,
    truncated run, or drift finding."""

    import json as _json

    results, drift = run_model_report(profile="full")
    text, worst = render_report(results)
    if worst == 1:
        worst = 2  # a truncated claim fails the CLI contract too
    if json_mode:
        print(_json.dumps({
            "models": [r.as_dict() for r in results],
            "drift": [{"message": m, "hint": h} for m, h in drift],
        }, indent=2))
    else:
        print(text)
        for message, hint in drift:
            print("drift: %s\n    hint: %s" % (message, hint))
        status = "clean" if worst < 2 and not drift else "FAILED"
        print("model: %s — %d models, %d states, %.2fs" % (
            status, len(results), sum(r.states for r in results),
            sum(r.duration_s for r in results)))
    return 1 if (worst >= 2 or drift) else 0


@register
class ProtocolModelChecker(Checker):
    name = "protocol-model"
    description = (
        "holds the executable protocol models (windowed-PUT, stream, "
        "durable floor, replication chain, group fencing) against the "
        "extracted wire dialogue (drift gate) and, on the live tree, "
        "exhaustively explores them under crash injection"
    )

    def run(self, index):
        d = extract_dialogue(index)
        if d is None:
            return
        table_fi, table_line, _var = d["table"]
        models = all_models()
        full = all(rel in index.by_rel for rel in _TRANSPORT_RELS)

        for message, hint in check_drift(d, models, full):
            yield Finding(
                checker=self.name, path=table_fi.rel, line=table_line,
                message=message, hint=hint,
            )

        if not full:
            return
        budget = REGISTRY_BUDGET_S / max(1, len(models))
        for model in models:
            result = explore(model, profile="quick", budget_s=budget)
            if result.violation is not None:
                yield Finding(
                    checker=self.name, path=table_fi.rel, line=table_line,
                    message=(
                        "protocol model %r violates invariant %r under "
                        "the bounded quick profile:\n%s" % (
                            model.name, result.violation,
                            render_trace(result))
                    ),
                    hint=(
                        "the modeled dialogue rules no longer uphold the "
                        "invariant — fix the transport (or the model, if "
                        "the wire rules legitimately changed)"
                    ),
                )
            elif not result.exhausted:
                yield Finding(
                    checker=self.name, path=table_fi.rel, line=table_line,
                    message=(
                        "protocol model %r did not exhaust its quick "
                        "profile (truncated by %s after %d states) — the "
                        "zero-counterexample claim does not hold" % (
                            model.name, result.truncated_by,
                            result.states)
                    ),
                    hint=(
                        "shrink the model's bounded config or raise "
                        "REGISTRY_BUDGET_S honestly"
                    ),
                )
