"""card_busy_spread.mesh: the largest minus the smallest card's busy share of
the profiler's window over the cell's cards, in percentage points: how
unevenly the mesh loads its cards."""


def read(ctx):
    dev = ctx.get("device")
    if not ctx.get("mesh") or not dev or dev["window_s"] <= 0 or len(dev["card_busy_s"]) < 2:
        return None
    busy = dev["card_busy_s"].values()
    return 100.0 * (max(busy) - min(busy)) / dev["window_s"]
