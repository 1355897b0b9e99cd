"""reduce_link_share.mesh: the least time the window's reductions need (the
bytes each card receives in them, as the ``su_als.reduce`` spans count
them, at NVLink 4's 450 GB/s each way) over the time those spans
measured, in %."""
from mfbench.links import NVLINK_BYTES_S


def read(ctx):
    mesh = ctx.get("mesh")
    if not mesh or not mesh["reduce_ms"] or sum(mesh["reduce_ms"]) <= 0:
        return None
    least_s = sum(mesh["reduce_bytes"]) / mesh["cards"] / NVLINK_BYTES_S
    return 100.0 * least_s / (sum(mesh["reduce_ms"]) / 1e3)
