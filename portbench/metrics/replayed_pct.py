"""The share of the profiled slice's train steps that replayed a CUDA
graph, in %: the program's ``train.step`` roots aligned on the benchmark's
steps (``portbench/program_spans.py``) that hold a ``train.replay`` span.
None where the program keeps no span record or it does not fit the
slice."""

from portbench import program_spans


def read(found):
    trace = found.get("trace")
    if not trace or not trace.units:
        return None
    spans = program_spans.record()
    units = None if spans is None else program_spans.aligned(
        trace, spans, "train.step")
    if not units:
        return None
    replayed = sum(any(name == "train.replay" for name, _, _ in unit)
                   for unit in units)
    return 100.0 * replayed / len(units)
