"""Mean device queue depth at launch over the window's dispatch records:
the launches queued ahead of each, open on the host or not yet passed by
the device, itself included (the port's device plane; the sum per site
is the eighth field of its ``ProberStats.device_sites`` aggregate)."""


def read(probe):
    aggs = [v for v in probe.sites.values() if len(v) > 7]
    n = sum(v[0] for v in aggs)
    if not n:
        return None
    return sum(v[7] for v in aggs) / n
