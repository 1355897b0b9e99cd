"""device_idle.sgd: the share of a profiler window of a few SGD epochs in
which no operation ran on the device, in %."""


def read(ctx):
    dev = ctx.get("device")
    if ctx.get("solver") != "sgd" or not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
