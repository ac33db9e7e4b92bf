"""Host time a batch inside the program's ``serve.forward`` span (the
model's forward dispatched from the host) in the profiled slice, in ms,
the profiler's own cost included (``portbench/program_spans.py``). It
moves ``eval_img_per_s`` only once it exceeds the device's busy time a
batch; until then it is the host's margin."""

from portbench import program_spans


def read(found):
    return program_spans.span_ms(found, "serve.infer", "serve.forward")
