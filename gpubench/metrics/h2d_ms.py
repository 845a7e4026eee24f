"""Device time of host-to-device copies per traced sample (the layout
upload, the model's tables): torch.profiler's Memcpy HtoD activity."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.samples:
        return None
    t = tr.device_seconds(lambda n: "Memcpy HtoD" in n)
    return 1e3 * t / tr.samples if t > 0 else None
