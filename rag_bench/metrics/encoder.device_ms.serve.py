"""Device milliseconds per launch of the port's device site
``encoder.forward`` (CUDA events of its device plane) in the window."""


def read(probe):
    got = probe.site("encoder.forward")
    return None if got is None else 1e3 * got[1] / got[0]
