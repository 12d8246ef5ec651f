"""Model: group coordinator with generation fencing ('N' cluster RPC).

Mirrors cluster/group.py + coordinator.py: every membership mutation
(join, expiry) bumps the group generation; every member request carries
the generation it last learned; the coordinator answers ``fenced`` to
any request whose generation is stale or whose sender it no longer
considers a member.  A fenced member drops its session and must rejoin
before mutating anything again.

Invariant:

- ``stale-commit-always-fenced``: a drained-partition commit carrying a
  stale generation (or sent by an expired member) is never applied.
  This is the fenced-drain-commit race: an
  expired member finishing its drain must not move the group's floor.

Seeded mutation (``check_generation=False``): the coordinator applies
whatever commit arrives — the invariant fires as soon as an expired
member's commit lands.
"""

from __future__ import annotations

from .core import Model

MEMBERS = (0, 1)


class GroupFencingModel(Model):
    name = "fencing"
    title = "group coordinator generation fencing ('N')"
    WIRE_OPS = frozenset({"_OP_CLUSTER"})
    WIRE_STATUSES = frozenset({"_ST_OK"})

    def __init__(self, check_generation=True):
        self.check_generation = check_generation

    def config(self, profile):
        if profile == "quick":
            return {"crashes": 1}
        return {"crashes": 2}

    def init_state(self, cfg):
        # (gen, in_group, known_gen, bad_commit, crashes_left)
        # in_group / known_gen are per-member tuples; known_gen 0 means
        # the member holds no session.
        return (0, (False,) * len(MEMBERS), (0,) * len(MEMBERS), False,
                cfg["crashes"])

    def actions(self, state, cfg):
        gen, in_group, known, bad, crashes = state

        for m in MEMBERS:
            # Join (or rejoin after a fence): bumps the generation and
            # hands the member the new one.
            if not in_group[m]:
                yield ("member%d N join -> gen=%d" % (m, gen + 1),
                       (gen + 1, _set(in_group, m, True),
                        _set(known, m, gen + 1), bad, crashes))

            # Coordinator-side expiry (missed heartbeats): the member is
            # dropped and the generation bumps, but the member itself
            # still holds its old session state.
            if in_group[m] and crashes > 0:
                yield ("coordinator expires member%d -> gen=%d"
                       % (m, gen + 1),
                       (gen + 1, _set(in_group, m, False), known, bad,
                        crashes - 1))

            # Heartbeat from a member holding a session: a stale
            # generation is answered fenced and the session dies.
            if known[m] > 0 and (known[m] != gen or not in_group[m]):
                yield ("member%d N heartbeat gen=%d -> fenced"
                       % (m, known[m]),
                       (gen, in_group, _set(known, m, 0), bad, crashes))

            # Drained-partition commit from a member holding a session.
            if known[m] > 0:
                stale = known[m] != gen or not in_group[m]
                if stale and self.check_generation:
                    yield ("member%d N commit-drained gen=%d -> fenced"
                           % (m, known[m]),
                           (gen, in_group, _set(known, m, 0), bad,
                            crashes))
                elif stale:
                    yield ("member%d N commit-drained gen=%d -> APPLIED"
                           % (m, known[m]),
                           (gen, in_group, known, True, crashes))
                # A fresh-generation commit applies without changing the
                # membership state; it is a no-op for exploration.

    def violations(self, state, cfg):
        _gen, _in_group, _known, bad, _crashes = state
        return ["stale-commit-always-fenced"] if bad else []


def _set(tup, i, val):
    return tup[:i] + (val,) + tup[i + 1:]
