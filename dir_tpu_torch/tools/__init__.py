"""Measurement tools of the port (``python -m dir_tpu_torch.tools.<name>``),
the counterparts of the JAX package's ``tools/`` of the same names:

* ``bench_components``: the backbone (both stems), the MANO pair, the bone
  splat (plain version and K5) and the full model, each timed alone;
* ``bench_input_pipeline``: the host and device input pipelines;
* ``bench_serve_concurrent``: concurrent HTTP serving, single-flight and
  micro-batched;
* ``bench_serve_latency``: per-request serving latency by batch size;
* ``bench_train``: the train step;
* ``bench_train_pipeline``: loader-fed training;
* ``quant_accuracy``: the int8 modes' accuracy against fp.
"""
