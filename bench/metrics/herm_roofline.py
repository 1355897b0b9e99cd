"""herm_roofline: the least time the window's Hermitians need (operations
over the float32 peak or bytes over HBM bandwidth, whichever is larger,
from shapes), over the time CUDA events measured around each call of
``repro_torch.kernels.ops.fused_herm``, in %."""
from mfbench.peaks import bound_s


def read(ctx):
    calls = ctx["calls"].get("fused_herm")
    if ctx.get("solver") != "als" or not calls:
        return None
    return 100.0 * sum(bound_s(ops, nb) for _, ops, nb in calls) / (sum(ms for ms, _, _ in calls) / 1e3)
