"""Write the reference record: ``dir_tpu``'s own outputs on the port's seeded
full-size flagship (``tests/data/torch_port_reference.npz``), which
``dir_tpu_torch/reference.py`` reads with numpy and ``chip_smoke.py`` and
``tests/test_torch_port_reference.py`` hold the port to.

    JAX_PLATFORMS=cpu python tests/torch_port_reference.py

runs on the CPU (some minutes) and rewrites the file; the same code and
versions write the same arrays. The steps:

* the port's flagship DIR (ResNet-50, 256x256) with ``random_init_``'s
  seed-0 weights, as ``serve.build_flagship`` draws them; their digest;
  ``serve.condition_random_`` once at fp32 on the CPU; every tensor that
  changed (BatchNorm statistics, the MANO heads' biases);
* those weights into ``dir_tpu`` by ``convert_torch_dir_state``; the
  synthetic MANO pair of ``serve.flagship_mano``;
* ``dir_tpu`` at fp32, full depth, ``highest`` matmul precision, on its
  plain routes (``fused_bottleneck_eval`` and ``use_pallas_splat`` off: the
  kernels K1, K2 and K5 equal them, and Pallas in interpret mode at full
  size is slow): A (``fused_splat_conv``) and B (without), all three
  stages and seg/dense, on four seeded images;
* C: ``dir_tpu`` with configuration C's flags on the bf16 trunk and its
  fused int8 kernel off (the unfused int8 route, to which K3 is bit-equal),
  calibrated on ``chip_smoke.py``'s 16 seeded images; the scales through
  the ``quant_stats`` bridge and C's outputs;
* T: one fp32 ``jax.value_and_grad`` of ``dir_tpu``'s total loss, as its
  train step computes it, with B's decoder flags on ``bench.py``'s seeded
  batch of 2: the loss terms, every parameter's gradient norm, the whole
  gradient of the stem conv and of one MANO head.
"""

from __future__ import annotations

import io
import os
import sys
import time
import zipfile

import numpy as np
import torch

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_reference.npz")
# dir_tpu's flags of each configuration: A and B on the plain routes, C with
# configuration C's int8 flags on the bf16 trunk (its fused int8 kernel
# stays off: ``dir_tpu.models.resnet._QUANT_FUSED`` is 0), T with B's
# decoder flags.
JAX_FLAGS = {
    "A": dict(fused_splat_conv=True),
    "B": dict(fused_splat_conv=False),
    "C": dict(dtype="bfloat16", quant_backbone_eval=True,
              quant_decoder_eval=True, quant_aux_eval=True,
              quant_static=True),
    "T": dict(fused_splat_conv=False),
}


def say(msg: str) -> None:
    print(f"[torch_port_reference] {msg}", flush=True)


def port_weights():
    """(digest of the drawn state_dict, the drawn state_dict, the tensors
    conditioning changed)."""
    from dir_tpu_torch import reference
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import condition_random_, flagship_mano
    from dir_tpu_torch.weights import random_init_

    model = random_init_(DIR(ModelConfig(dtype="float32")), reference.SEED)
    drawn = {k: v.clone() for k, v in model.state_dict().items()}
    condition_random_(model, *flagship_mano("/nonexistent"),
                      seed=reference.SEED)
    changed = {k: v.clone() for k, v in model.state_dict().items()
               if not torch.equal(v, drawn[k])}
    return reference.state_digest(drawn), drawn, changed


def jax_variables(state_dict: dict) -> dict:
    """The port's state_dict as ``dir_tpu``'s variables, through its own
    torch converter."""
    from dir_tpu.train.checkpoint import convert_torch_dir_state

    params, stats = convert_torch_dir_state(
        {k: v.numpy() for k, v in state_dict.items()})
    return {"params": params, "batch_stats": stats}


def jax_manos():
    from dir_tpu.mano import fix_left_shapedirs, synthetic_mano

    right = synthetic_mano("right", seed=0)
    return fix_left_shapedirs(synthetic_mano("left", seed=0), right), right


def jax_model(config: str):
    from dir_tpu.config import ModelConfig
    from dir_tpu.models.dir import DIR

    return DIR(ModelConfig(**JAX_FLAGS[config]))


def jax_forward(variables: dict, img: np.ndarray, config: str) -> dict:
    """``dir_tpu``'s eval forward of A or B, flattened."""
    import jax
    import jax.numpy as jnp

    from dir_tpu_torch import reference

    ml, mr = jax_manos()
    with jax.default_matmul_precision("highest"):
        out = jax_model(config).apply(variables, jnp.asarray(img), ml, mr,
                                      train=False)
    return reference.flatten(jax.device_get(out))


def jax_int8(variables: dict, calibration: np.ndarray, img: np.ndarray):
    """C: ``dir_tpu``'s calibration on ``calibration`` and its static int8
    forward on ``img``; returns (scales by port buffer name, outputs)."""
    import jax
    import jax.numpy as jnp

    from dir_tpu.ops import quant as jquant
    from dir_tpu_torch import reference
    from dir_tpu_torch.weights import quant_stats_to_amax

    ml, mr = jax_manos()
    model = jax_model("C")
    with jax.default_matmul_precision("highest"):
        _, ups = model.apply(variables, jnp.asarray(calibration), ml, mr,
                             train=False, mutable=["quant_stats"])
        ups = jax.device_get(ups)
        out = model.apply(jquant.merge_calibration(variables, ups),
                          jnp.asarray(img), ml, mr, train=False)
    amax = quant_stats_to_amax(jax.tree.map(np.asarray,
                                            dict(ups["quant_stats"])))
    return ({k: v.numpy() for k, v in amax.items()},
            reference.flatten(jax.device_get(out)))


def jax_train(variables: dict, batch: dict, dtype: str = "float32"):
    """T: one ``value_and_grad`` of ``dir_tpu``'s total loss as its train
    step computes it (``dir_tpu/train/steps.py:loss_for``), at fp32 or (with
    JAX's 64-bit mode on) fp64; returns the loss terms and the gradients in
    the port's layout."""
    import jax
    import jax.numpy as jnp

    from dir_tpu.config import ModelConfig
    from dir_tpu.models.dir import DIR
    from dir_tpu.models.losses import dir_losses, total_loss
    from dir_tpu_torch.weights import jax_to_state_dict

    def cast(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(x, dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else jnp.asarray(x), tree)

    ml, mr = cast(jax_manos())
    cfg = ModelConfig(**dict(JAX_FLAGS["T"], dtype=dtype))
    model = DIR(cfg)
    variables = cast(variables)
    jb = cast(batch)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["img"], ml, mr, train=True, mutable=["batch_stats"])
        terms = dir_losses(out, jb, cfg, ml.faces, mr.faces,
                           fused_stages=True)
        return total_loss(terms), terms

    with jax.default_matmul_precision("highest"):
        (_, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
    terms = {k: float(v) for k, v in jax.device_get(terms).items()}
    grads = jax_to_state_dict(jax.tree.map(np.asarray, grads), {})
    return terms, {k: v.numpy() for k, v in grads.items()}


def make_record() -> dict:
    from dir_tpu_torch import reference

    t = time.monotonic()
    digest, drawn, changed = port_weights()
    arrays = {"digest": np.array(digest)}
    arrays.update({f"conditioned/{k}": v.numpy() for k, v in changed.items()})
    variables = jax_variables({**drawn, **changed})
    say(f"weights drawn and conditioned, digest {digest}, {len(changed)} "
        f"conditioned tensors ({time.monotonic() - t:.1f} s)")
    img = reference.images()
    for config in ("A", "B"):
        t = time.monotonic()
        out = jax_forward(variables, img, config)
        arrays.update({f"{config}/{k}": v for k, v in out.items()})
        say(f"{config}: {len(out)} outputs ({time.monotonic() - t:.1f} s)")
    t = time.monotonic()
    amax, out = jax_int8(variables, reference.calibration_images(), img)
    arrays.update({f"C/{k}": v for k, v in out.items()})
    arrays.update({f"C/amax/{k}": v for k, v in amax.items()})
    say(f"C: {len(amax)} scales, {len(out)} outputs "
        f"({time.monotonic() - t:.1f} s)")
    t = time.monotonic()
    terms, grads = jax_train(variables, reference.train_batch())
    arrays.update(reference.train_record(terms, grads))
    say(f"T: {len(terms)} loss terms, {len(grads)} gradients "
        f"({time.monotonic() - t:.1f} s)")
    return arrays


def write(arrays: dict, path: str) -> None:
    """An ``.npz`` that ``np.load`` reads, written byte for byte the same
    for the same arrays (sorted entries, a fixed time stamp)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for key in sorted(arrays):
            info = zipfile.ZipInfo(f"{key}.npy", date_time=(1980, 1, 1, 0, 0,
                                                            0))
            info.compress_type = zipfile.ZIP_DEFLATED
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[key]),
                                      allow_pickle=False)
            z.writestr(info, buf.getvalue())


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    arrays = make_record()
    write(arrays, RECORD)
    say(f"wrote {RECORD}: {len(arrays)} arrays, "
        f"{os.path.getsize(RECORD)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
