"""Component-level microbenchmarks of the port: where a forward's time goes
(counterpart of ``tools/bench_components.py``).

Times, at batch ``BATCH`` (64): the backbone alone with each stem, the MANO
pair, one refinement stage's bone splat at both stage sizes (plain version
and kernel), and the full model in bf16. The entries, their names and their
order are the JAX tool's, letter for letter:

* ``backbone_conv7``, ``backbone_s2d``: ``models/resnet.py:ResNetPyramid``
  in bf16 at the default depth (3, 4, 6, 3), its last level (c4);
* ``mano_pair``: ``mano_forward_pca6d`` of the left and of the right hand,
  their vertices summed, in fp32 with TF32 off as the port runs MANO
  everywhere;
* ``splat32_jnp``, ``splat32_pallas``, ``splat16_jnp``, ``splat16_pallas``:
  the bone splat at (size, distance) (32, 2.0) and (16, 1.0). ``_jnp`` runs
  the plain version, ``ops/bone_splat.py:bone_splat_plain``; ``_pallas``
  runs ``ops/bone_splat.py:bone_splat``, which on the card launches kernel
  K5 (``csrc/bone_splat.cu``);
* ``full_bf16_pallas=False``, ``full_bf16_pallas=True``: the DIR with
  ``ModelConfig(dtype="bfloat16", use_pallas_splat=...)``, every other
  field at its default, the eval forward, the final stage's
  ``pd_mesh_xyz_left``. As in the JAX tool, ``fused_splat_conv`` defaults to
  True, so ``use_pallas_splat`` routes nothing: the two entries run the same
  program and neither launches K5. ``fused_bottleneck_eval`` stays off, so
  K1 is not on this path either.

The backbones and the models run on zero weights, as the JAX tool's do:
every parameter and every floating-point buffer (the BatchNorm statistics,
the JAX package's ``batch_stats``) is zeroed; the int64 index buffers are
constants, not variables, in both packages. The inputs are the JAX tool's
draws from ``np.random.RandomState(0)``, in its order (:func:`draws`); the
image goes to the backbone in the port's NCHW layout, as a view of the NHWC
upload. Everything runs under ``torch.inference_mode()`` with TF32 off.

Each entry: one untimed call (the JAX tool's compile call), ``ITERS`` (10)
calls, one synchronise. On the card one more call is traced with
``torch.profiler`` and a line comes before the JAX tool's:

    component <name>: device_ms=x.xxx launches=N busy=xx.x% k5=N

``device_ms`` is the union of the call's kernel intervals, ``launches`` its
kernels, ``busy`` ``device_ms`` over the timed calls' wall time a call,
``k5`` the call's K5 launches (``bone_splat.launches``). The traced call's
own wall time is not used: the profiler's host work inflates it (on the
H100 the backbone's traced call kept the device busy a third of its wall
time, its timed calls about nine tenths). The JAX tool times a jitted
program with no host dispatch; the port dispatches eagerly, so its wall
time alone cannot say whether an entry is bound by the host. Every entry's
output is checked finite. Runs on the card, ``BENCH_DEVICE=cpu`` on the CPU
(the tests); with no card and no CPU request it exits non-zero with one
error line:

    python -m dir_tpu_torch.tools.bench_components

One line per entry:
    backbone_conv7: xx.xx ms/iter (xxxx img/s)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dir_tpu_torch.bench import bench_device, check_finite, synchronize

BATCH = 64
ITERS = 10
NAMES = ("backbone_conv7", "backbone_s2d", "mano_pair", "splat32_jnp",
         "splat32_pallas", "splat16_jnp", "splat16_pallas",
         "full_bf16_pallas=False", "full_bf16_pallas=True")
# (size, distance) of the two refinement stages' splats
SPLATS = ((32, 2.0), (16, 1.0))


def draws(batch: int = BATCH) -> dict:
    """The JAX tool's numpy draws, in its order: the NHWC image, the MANO
    pose and shape, the joints' uv and features (fp32 here; the tool casts
    the features to bf16)."""
    rng = np.random.RandomState(0)
    img = rng.randn(batch, 256, 256, 3).astype(np.float32)
    pose = rng.randn(batch, 51).astype(np.float32)
    betas = rng.randn(batch, 10).astype(np.float32)
    uv = rng.uniform(-1, 1, (batch, 21, 2)).astype(np.float32)
    feat = rng.randn(batch, 21, 64).astype(np.float32)
    return dict(img=img, pose=pose, betas=betas, uv=uv, feat=feat)


def manos(dev: torch.device) -> tuple:
    """(left, right): the seeded synthetic pair with the left fix."""
    from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano

    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    return left.to(dev), right.to(dev)


def zero_(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and floating-point buffer set to 0."""
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            if t.is_floating_point():
                t.zero_()
    return module


def backbone(stem: str, dev: torch.device, dtype=torch.bfloat16,
             layers=(3, 4, 6, 3)) -> torch.nn.Module:
    """The backbone of one stem on zero weights, in eval mode."""
    from dir_tpu_torch.models.resnet import ResNetPyramid

    model = ResNetPyramid(layers, dtype=dtype, stem=stem)
    return zero_(model).to(dev).eval()


def full_model(use_pallas: bool, dev: torch.device, dtype="bfloat16",
               **overrides) -> torch.nn.Module:
    """The DIR of ``ModelConfig(dtype=..., use_pallas_splat=...)`` on zero
    weights, in eval mode; ``overrides`` are further ``ModelConfig``
    fields."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR

    model = DIR(ModelConfig(dtype=dtype, use_pallas_splat=use_pallas,
                            **overrides))
    return zero_(model).to(dev).eval()


def c4(model):
    return lambda x: model(x)[-1]


def mano_pair(left, right):
    from dir_tpu_torch.mano.layer import mano_forward_pca6d

    return lambda p, b: (mano_forward_pca6d(left, p, b, center_idx=0)[0]
                         + mano_forward_pca6d(right, p, b, center_idx=0)[0])


def splat(size: int, distance: float, kernel: bool):
    """The bone splat at one stage's size: through K5 (``kernel``) or the
    plain version."""
    from dir_tpu_torch.ops.bone_splat import bone_splat, bone_splat_plain

    fn = bone_splat if kernel else bone_splat_plain
    return lambda u, f: fn(u, f, size, distance)


def final_mesh_left(model, left, right):
    return lambda x: model(x, left, right)["stages"][-1]["pd_mesh_xyz_left"]


def entries(dev: torch.device, data: dict, **overrides):
    """``(name, fn, args)`` of the nine entries, in order, each model built
    only when its entry comes up; ``overrides`` are further ``ModelConfig``
    fields (``backbone_layers`` also sets the lone backbones' depth)."""
    img = torch.from_numpy(data["img"]).to(dev)
    left, right = manos(dev)
    layers = overrides.get("backbone_layers", (3, 4, 6, 3))
    for stem in ("conv7", "s2d"):
        yield (f"backbone_{stem}", c4(backbone(stem, dev, layers=layers)),
               (img.permute(0, 3, 1, 2),))
    pose = torch.from_numpy(data["pose"]).to(dev)
    betas = torch.from_numpy(data["betas"]).to(dev)
    yield "mano_pair", mano_pair(left, right), (pose, betas)
    uv = torch.from_numpy(data["uv"]).to(dev)
    feat = torch.from_numpy(data["feat"]).to(dev, torch.bfloat16)
    for size, distance in SPLATS:
        for kernel, suffix in ((False, "jnp"), (True, "pallas")):
            yield (f"splat{size}_{suffix}", splat(size, distance, kernel),
                   (uv, feat))
    for use_pallas in (False, True):
        yield (f"full_bf16_pallas={use_pallas}",
               final_mesh_left(full_model(use_pallas, dev, **overrides),
                               left, right), (img,))


def trace(fn, args, dev: torch.device) -> dict:
    """One more call of ``fn`` under ``torch.profiler``: its device busy
    time, kernel launches and K5 launches."""
    from torch.profiler import ProfilerActivity, profile

    from dir_tpu_torch.ops.bone_splat import bone_splat
    from dir_tpu_torch.profile_serve import busy_us

    before = bone_splat.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        synchronize(dev)
    k5 = bone_splat.launches - before
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ms": busy_us(kernels) / 1e3, "launches": len(kernels),
            "k5": k5}


def timeit(name: str, fn, *args, batch: int = BATCH, iters: int = ITERS,
           dev: torch.device) -> dict:
    """One untimed call, ``iters`` timed calls, one synchronise; on the card
    a traced call after them. Prints the ``component`` line (the card) and
    the JAX tool's line; returns the numbers and the last output."""
    out = fn(*args)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    check_finite([out], name)
    rec = {"name": name, "ms": dt * 1000, "img_per_s": batch / dt}
    if dev.type == "cuda":
        rec.update(trace(fn, args, dev))
        rec["busy"] = rec["device_ms"] / rec["ms"]
        print(f"component {name}: device_ms={rec['device_ms']:.3f} "
              f"launches={rec['launches']} busy={rec['busy'] * 100:.1f}% "
              f"k5={rec['k5']}", flush=True)
    print(f"{name}: {dt * 1000:.2f} ms/iter ({batch / dt:.0f} img/s)",
          flush=True)
    rec["out"] = out
    return rec


def main(batch: int = BATCH, iters: int = ITERS, **overrides) -> list:
    """Time the nine entries; returns their numbers (without the outputs).
    ``overrides`` are further ``ModelConfig`` fields."""
    from dir_tpu_torch.device import no_tf32

    dev = bench_device()
    records = []
    with torch.inference_mode(), no_tf32():
        for name, fn, args in entries(dev, draws(batch), **overrides):
            rec = timeit(name, fn, *args, batch=batch, iters=iters, dev=dev)
            del rec["out"], fn
            records.append(rec)
    return records


if __name__ == "__main__":
    try:
        bench_device()
    except RuntimeError as e:
        raise SystemExit(f"bench_components: {e}")
    main()
