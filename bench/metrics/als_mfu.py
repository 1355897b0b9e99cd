"""als_mfu: the algorithm's operations in one ALS iteration (both
Hermitians, both solves, the RMSE predictions; from shapes) over the
traced window's host-clock time per iteration and the float32 peak, in %."""
from mfbench.peaks import PEAK_FP32_FLOPS


def read(ctx):
    if ctx.get("solver") != "als" or not ctx.get("steps"):
        return None
    return 100.0 * ctx["step_ops"] / (ctx["window_s"] / ctx["steps"]) / PEAK_FP32_FLOPS
