"""Device time a step of the copies between two cards: the operations the
profiler names ``Memcpy PtoP`` (a peer-to-peer copy, from one card's
memory to another's), clipped to the traced window, in ms over the
profiled steps. On a cell of several cards these are z's replicas taking
each committing agent's z-delta, the agents' rows, weights and losses;
None when the trace holds no such copy (one card)."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "agents across cards", "step_s"
PEER = "Memcpy PtoP"


def read(record):
    t = record.trace
    if t is None:
        return None
    lo, hi = t.window
    us = [min(e, hi) - max(s, lo) for n, s, e in t.device if n.startswith(PEER)]
    return sum(u for u in us if u > 0) * 1e-3 / t.n_steps if us else None
