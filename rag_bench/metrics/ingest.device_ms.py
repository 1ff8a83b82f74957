"""Device milliseconds per launch of the port's device site
``ingest.fused`` (encoder forward and slot write of one batch; CUDA
events of its device plane) in the window."""


def read(probe):
    got = probe.site("ingest.fused")
    return None if got is None else 1e3 * got[1] / got[0]
