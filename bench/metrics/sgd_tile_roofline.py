"""sgd_tile_roofline: the least time the window's SGD sweeps need (6 f
operations a rating over the float32 peak, or the bytes of X, the set's
Theta blocks and the ratings over HBM bandwidth, whichever is larger),
over the time CUDA events measured around each call of the sweep
(``sgd_tile_planned_`` as ``sgd_train`` calls it), in %."""
from mfbench.peaks import bound_s


def read(ctx):
    calls = ctx["calls"].get("sgd_tile")
    if ctx.get("solver") != "sgd" or not calls:
        return None
    return 100.0 * sum(bound_s(ops, nb) for _, ops, nb in calls) / (sum(ms for ms, _, _ in calls) / 1e3)
