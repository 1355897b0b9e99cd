"""sgd_mfu: an epoch's 6 f operations a train rating over the traced
window's host-clock time per epoch and the float32 peak, in %."""
from mfbench.peaks import PEAK_FP32_FLOPS


def read(ctx):
    if ctx.get("solver") != "sgd" or not ctx.get("steps"):
        return None
    return 100.0 * ctx["step_ops"] / (ctx["window_s"] / ctx["steps"]) / PEAK_FP32_FLOPS
