"""Typed serving failures — the error taxonomy every Answer.status draws
from (port of repro/serve/errors.py, unchanged).

A query server must never let one bad request poison its tick: a
malformed submit, an evicted graph, a blown deadline, a flaky engine, or
a capped solver each get a DISTINCT exception class carrying a stable
wire ``code``, and the scheduler (serve/scheduler.py) converts them into
per-query ``Answer(status=<code>, error=<instance>)`` records instead of
raising across the batch.  Only :class:`QueryRejected` is ever raised to
the submitting caller (fail-fast validation and queue saturation — the
backpressure signal); everything after admission surfaces as an Answer.

The taxonomy:

=================  ===================  ====================================
class              code                 raised / answered when
=================  ===================  ====================================
QueryRejected      rejected             submit-time validation failure, or
                                        the bounded queue is saturated
                                        (reject-on-saturation backpressure /
                                        load shedding)
GraphGone          graph_gone           the graph was evicted (or never
                                        registered) between submit and the
                                        serving tick
DeadlineExceeded   deadline_exceeded    the query's deadline passed before
                                        an engine could serve it
SolveFailed        solve_failed         an engine solve (or operand staging)
                                        raised and the per-query retry
                                        budget is exhausted
GroupBroken        solve_failed         a rank of the serving group died or
                                        raised (core/_dist.ServingGroup):
                                        answered at once, never retried
NotConverged       not_converged        the fixpoint engine hit its
                                        ``max_sweeps`` cap before
                                        convergence (SsspResult.converged
                                        False) — the labels may sit above
                                        their fixpoint and are never served
                                        as exact
SchedulerStalled   stalled              drain()'s progress guard: a tick
                                        served zero queries and retired
                                        zero (everything requeued), so the
                                        loop would spin forever
=================  ===================  ====================================

``STATUS_OK`` ("ok") is the non-error status; degraded answers (landmark
bounds, stale cache rows) keep status "ok" but carry ``exact=False`` —
the taxonomy separates *failed* from *approximate*, and the bitwise
exactness invariant binds only answers claiming ``exact=True``.
"""
from __future__ import annotations

STATUS_OK = "ok"


class ServeError(Exception):
    """Base of the serving error taxonomy; ``code`` is the stable status
    string the scheduler stamps onto failed Answers."""

    code = "error"


class QueryRejected(ServeError):
    """Refused at submit time: malformed (source/target out of range,
    non-integer, negative) or shed by the bounded queue's backpressure."""

    code = "rejected"


class GraphGone(ServeError):
    """The query's graph is not registered at serving time — evicted
    between submit and tick, or never admitted."""

    code = "graph_gone"


class DeadlineExceeded(ServeError):
    """The query's deadline passed before an engine served it."""

    code = "deadline_exceeded"


class SolveFailed(ServeError):
    """An engine solve or operand staging raised, and retries (capped
    exponential backoff, per-query budget) did not recover it."""

    code = "solve_failed"


class GroupBroken(SolveFailed):
    """A rank of the serving group that runs the sharded engines
    (core/_dist.ServingGroup) died or raised, so the group can serve no
    more sharded solves: this one and every later one fail at once with
    this error, which names the ``rank``.  Graphs served on one device go
    on serving.  It keeps SolveFailed's ``code``."""

    def __init__(self, message: str, *, rank: int):
        super().__init__(message)
        self.rank = rank


class NotConverged(ServeError):
    """The fixpoint engine stopped at its ``max_sweeps`` cap with work
    remaining (``SsspResult.converged`` False): the distances may sit
    above their fixpoint, so they are reported as a typed failure rather
    than silently served.  Also the hook Johnson-style negative-cycle
    detection will raise through once negative weights land."""

    code = "not_converged"


class SchedulerStalled(ServeError):
    """drain()'s progress guard tripped: a tick had eligible work but
    served zero queries and retired zero — without the guard the drain
    loop would spin forever."""

    code = "stalled"


#: every status value an Answer can carry: "ok" plus the taxonomy codes.
STATUSES = (STATUS_OK,) + tuple(
    cls.code for cls in (QueryRejected, GraphGone, DeadlineExceeded,
                         SolveFailed, NotConverged, SchedulerStalled))
