"""Device milliseconds per launch of the port's device site ``knn.fused``
(the partial and merge kernels; CUDA events of its device plane) in the
window."""


def read(probe):
    got = probe.site("knn.fused")
    return None if got is None else 1e3 * got[1] / got[0]
