"""Device time of the host-to-device copies per batch in the profiled
slice, in ms (the image upload of ``serve.make_infer``)."""


def read(found):
    trace = found["trace"]
    copies = trace.copies("HtoD") if trace else []
    if not copies:
        return None
    return sum(e - s for _, s, e in copies) * 1e-3 / trace.units
