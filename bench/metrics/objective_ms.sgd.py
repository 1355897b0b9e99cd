"""objective_ms.sgd: device milliseconds per SGD epoch of the loop's test-RMSE
call (``rmse_padded`` as ``sgd_train`` calls it), CUDA events around each
call in the traced window."""


def read(ctx):
    calls = ctx["calls"].get("objective")
    if ctx.get("solver") != "sgd" or not calls or not ctx.get("steps"):
        return None
    return sum(calls) / ctx["steps"]
