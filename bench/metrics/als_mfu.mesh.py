"""als_mfu.mesh: the algorithm's operations in one ALS iteration (both
Hermitians, both solves, the RMSE predictions; from shapes, as
``als_mfu`` counts them) over the traced window's host-clock time per
iteration and the float32 peak of every card of the mesh, in %."""
from mfbench.peaks import PEAK_FP32_FLOPS


def read(ctx):
    mesh = ctx.get("mesh")
    if not mesh or ctx.get("solver") != "als" or not ctx.get("steps") or "step_ops" not in ctx:
        return None
    per_step_s = ctx["window_s"] / ctx["steps"]
    return 100.0 * ctx["step_ops"] / per_step_s / (mesh["cards"] * PEAK_FP32_FLOPS)
