"""The share of the time in which no kernel or copy ran on the device, in
%: one minus the device's busy time a call in the profiled slice (the
union of its kernel and copy intervals) over the wall time a call outside
the slice. The profiler slows the host that drives the closed loop, so
the slice's own wall time would overstate the idle share."""


def read(found):
    trace = found["trace"]
    if not trace or not trace.device or not trace.units:
        return None
    busy = trace.busy_us * 1e-6 / trace.units
    return 100.0 * (1.0 - busy / found["unit_wall_s"])
