"""Device idle time a train step while the host was in the losses
(``dir_losses``, ``total_loss``), in ms: the phase's share of the
profiled slice's idle time, by the program's ``train.loss`` spans, times
a step's idle time outside the slice (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(found):
    by = program_spans.idle_ms_by_phase(found)
    return None if by is None else by["train.loss"]
