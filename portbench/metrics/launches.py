"""Device operations (kernels, copies, sets) launched per unit of the
profiled slice, from the profiler's CUDA events."""


def read(found):
    trace = found["trace"]
    if not trace or not trace.device:
        return None
    return len(trace.device) / trace.units
