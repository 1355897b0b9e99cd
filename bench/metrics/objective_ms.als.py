"""objective_ms.als: device milliseconds per ALS iteration of the loop's own
train- and test-RMSE calls (``als._rmse_bins``, ``als.rmse_padded``),
CUDA events around each call in the traced window."""


def read(ctx):
    calls = ctx["calls"].get("objective")
    if ctx.get("solver") != "als" or not calls or not ctx.get("steps"):
        return None
    return sum(calls) / ctx["steps"]
