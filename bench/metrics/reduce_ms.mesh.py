"""reduce_ms.mesh: device milliseconds per SU-ALS iteration covered by the
program's ``su_als.reduce`` spans (the reduction of the partial Hermitians
over the column cells; each span from the earliest start to the latest
end among the cards it touches, and the union of an iteration's spans,
since its phases overlap across cards), over the traced window's
iterations."""


def read(ctx):
    mesh = ctx.get("mesh")
    if not mesh or not mesh["reduce_ms"] or not ctx.get("steps"):
        return None
    return sum(mesh["reduce_ms"]) / ctx["steps"]
