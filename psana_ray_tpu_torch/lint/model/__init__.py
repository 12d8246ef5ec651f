"""Bounded explicit-state model checking of the wire protocol.

This package holds small *executable* models of the protocol roles the
repo actually ships — the client windowed-PUT sender, the credit-window
stream reader fed by the evloop pump, the durable log with its committed
floor, the replication chain owner/follower pair, and the group
coordinator with generation fencing — plus a breadth-first explorer that
walks EVERY interleaving of those models under a bounded configuration
(a handful of frames, crash/reconnect injections allowed at every
transition) and checks the invariants the repo has paid for in bugs:

- loss-never (at-least-once delivery)
- windowed-resend holes-never
- credit-window conservation
- EOS never overtakes redelivered frames
- replicated ack floor <= follower tail
- owner-behind-replica always self-fences
- stale-generation commits always fenced

The models are anchored to the code, not to a hand-kept spec: each model
declares the wire opcodes and reply statuses it implements, and
``drift.py`` asserts those declarations against the protocol-dialogue
reconstruction of tcp.py/evloop.py (``lint.flow.protocol.extract_dialogue``).
Editing the wire surface without updating a model is itself a lint
finding.

Everything here is stdlib-only, free of jax and torch, like the rest of lint.
"""

from .core import (  # noqa: F401
    ExploreResult,
    Model,
    explore,
    render_trace,
)
from .windowed import WindowedPutModel  # noqa: F401
from .stream import StreamModel  # noqa: F401
from .durable import DurableFloorModel  # noqa: F401
from .chain import ReplicationChainModel  # noqa: F401
from .fencing import GroupFencingModel  # noqa: F401

#: The live model fleet, in the order reports print them.  Each entry is
#: a zero-arg factory so seeded-mutation tests can build their own
#: (mutated) instances without touching this list.
MODEL_FACTORIES = (
    WindowedPutModel,
    StreamModel,
    DurableFloorModel,
    ReplicationChainModel,
    GroupFencingModel,
)


def all_models():
    """Fresh, unmutated instances of every shipped model."""

    return [factory() for factory in MODEL_FACTORIES]


def run_models(profile="full", budget_s=None):
    """Explore every shipped model; returns a list of ExploreResult."""

    out = []
    for model in all_models():
        out.append(explore(model, profile=profile, budget_s=budget_s))
    return out
