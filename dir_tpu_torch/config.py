"""Model configuration of the PyTorch port.

Copies of ``dir_tpu.config`` (same fields, same defaults; the model
config has a few port-only kernel fields), so that the port never imports
the JAX package. ``save_yaml`` writes JSON text, which is valid YAML 1.2:
the JAX package's ``load_yaml`` reads it, and the port reads it back with
``json`` alone.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DIR network hyperparameters (reference: models/dir.py:389-502)."""

    joint_num: int = 21
    num_verts: int = 778
    # Backbone pyramid channel dims (ResNet-50): c1..c4.
    backbone: str = "resnet50"
    backbone_layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    # Stem variant: "conv7" (torchvision layout) or "s2d" (space-to-depth
    # then a 4x4 stride-1 conv; models/resnet.py:stem_weights_to_s2d
    # rewrites conv7 weights exactly).
    backbone_stem: str = "conv7"
    backbone_dims: Tuple[int, int, int, int] = (256, 512, 1024, 2048)
    # Decoder feature dims per stage.
    decoder_dim: int = 256
    # Joint token embedding dim inside each refinement stage.
    embed_dim: int = 128
    # Per-joint output feature dim of the interaction transformer.
    joint_dim: int = 64
    # Bone-splat distance thresholds per refinement stage.
    stage_distances: Tuple[float, ...] = (1.0, 2.0)
    # MANO parameter vector: 6 (root 6D) + 45 (PCA pose) + 10 (shape) + 3 (cam).
    mano_ncomps: int = 45
    mano_param_dim: int = 6 + 45 + 10 + 3
    # STE transformer; blocks 1..depth-1 execute, block 0 is never built.
    ste_depth: int = 4
    ste_heads: int = 4
    ste_mlp_ratio: float = 2.0
    gcn_layers: int = 4
    # Index of the joint used to center MANO output (0 = wrist).
    root_joint: int = 0
    # Compute dtype of the conv/transformer trunk ("float32" | "bfloat16").
    # MANO, geometry and the parameter heads always run fp32.
    dtype: str = "float32"
    # Bone-splat kernel (ops/bone_splat.py) on the materialized splat
    # path, i.e. with fused_splat_conv=False; False runs its plain version.
    # The name is the JAX package's field.
    use_pallas_splat: bool = False
    # Inference-only fused bottleneck kernel for the 64x64 backbone
    # blocks (ops/fused_bottleneck.py); same parameters either way.
    fused_bottleneck_eval: bool = False
    # With fused_bottleneck_eval, > 0 also sends the stride-1 layer2 blocks
    # (32x32, 512 channels) through the fused route, as bands=N. The JAX
    # package reads this from the FUSED_L2_BANDS environment variable at
    # import; the port takes it as a field and reads no environment.
    fused_l2_bands: int = 0
    # Int8 serving options (ops/quant.py), inference only, same parameters
    # either way: the backbone's bottleneck convs, the decoder's Residual
    # convs, and the nine auxiliary convs (stem, attention pools, fusion
    # convs, final convs, seg/dense heads).
    quant_backbone_eval: bool = False
    quant_decoder_eval: bool = False
    quant_aux_eval: bool = False
    # Calibrated (static) activation scales instead of each batch's |max|;
    # needs one calibration forward (serve.calibrate_static_scales).
    quant_static: bool = False
    # With quant_backbone_eval and quant_static, the fused int8 bottleneck
    # kernel (ops/fused_bottleneck_int8.py) takes the stride-1 blocks with
    # >= 128 input channels at >= 4096 positions (layer1_1, layer1_2) and,
    # with quant_fused_l2_bands > 0, at >= 1024 positions (layer2_1..3, as
    # bands=N). The JAX package reads these from the QUANT_FUSED and
    # QUANT_FUSED_L2 environment variables at import.
    quant_fused: bool = False
    quant_fused_l2_bands: int = 0
    # MANO contraction precision of the JAX package ("high" is bf16x3 on a
    # TPU, plain fp32 on the CPU). The port accepts it and reads it
    # nowhere: MANO runs in fp32 with TF32 off in every case, which equals
    # dir_tpu on the CPU; Hopper has no counterpart of the TPU's bf16x3
    # pass that is not less precise.
    mano_precision: str = "highest"
    # Factored 3x3 fusion conv through the rank-1 splat structure.
    fused_splat_conv: bool = True
    bone_num: int = 20
    # Loss weights.
    coord_weight: float = 10.0
    dense_weight: float = 1.0
    seg_weight: float = 0.1
    lovasz_weight: float = 0.1
    normal_weight: float = 0.1
    edge_weight: float = 1.0
    seg_class_weights: Tuple[float, float, float] = (0.1, 0.45, 0.45)
    # Scale normalization constant for xyz-space embeddings.
    coord_scale: float = 0.15


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline settings (reference: config.py,
    dataset/dataset_utils.py)."""

    data_dir: str = "./data/interhand2.6m"
    img_size: int = 256
    # ImageNet normalization (RGB order).
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Augmentation ranges.
    aug_scale: float = 0.1
    aug_rot_deg: float = 180.0
    aug_transl_px: float = 10.0
    aug_flip: bool = True
    aug_blur_prob: float = 0.3
    aug_noise: float = 0.01
    # Loader threads.
    num_workers: int = 4
    # The host decodes JPEGs only; MANO ground truth, augmentation and
    # normalization run on the device per batch (data/device_pipeline.py).
    device_pipeline: bool = False
    # Host-path warp through native/imageops.cpp instead of cv2.
    native_warp: bool = False
    # Serve samples from the packed decode-once cache (data/sample_cache.py).
    packed_cache: bool = False
    # Ship train batches as uint8 (img/dense/seg) and normalize on the
    # device (train/steps.py:decode_wire8): the same values, fewer bytes.
    wire8: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings (reference: config.py:13-31, train.py:223-243)."""

    batch_size: int = 64
    total_epochs: int = 50
    lr: float = 5e-4
    lr_scheduler: str = "cosine"  # "cosine" | "step"
    step_milestones: Tuple[int, ...] = (30,)
    step_gamma: float = 0.1
    weight_decay: float = 0.01  # torch AdamW default
    seed: int = 25
    print_every: int = 100
    draw_every: int = 100  # skeleton-overlay dumps (0 disables)
    eval_every_epochs: int = 1
    # Optimizer steps per call of the train step (train/steps.py: unroll),
    # on stacked batches; the same math as one step per call.
    steps_per_call: int = 1
    # Micro-batches whose gradients are summed in fp32 and averaged into one
    # optimizer step (train/steps.py: grad_accum); batch_size is the
    # micro-batch size. Mutually exclusive with steps_per_call > 1.
    grad_accum: int = 1
    # In-loop eval metric: "benchmark" (the offline eval metric) or
    # "online" (the reference Trainer's own).
    inloop_metric: str = "benchmark"
    output_dir: str = "./output/dir_tpu"
    checkpoint: str = ""
    continue_train: bool = False
    # Data-parallel size; 0 means all local devices.
    mesh_data_axis: int = 0
    # Compute dtype for the network (MANO + losses stay f32 for parity).
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mano_assets: str = "./assets/mano"


def default_config() -> Config:
    return Config()


_SECTIONS = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig}


def _to_dict(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _to_dict(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _SECTIONS:
            v = _from_dict(_SECTIONS[f.name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_yaml(cfg: Config, path: str) -> None:
    """Write the whole config as JSON text (valid YAML 1.2), fields in
    declaration order."""
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=2)
        f.write("\n")


def load_yaml(path: str) -> Config:
    """Read a config written by :func:`save_yaml`; missing keys keep their
    defaults, unknown keys are ignored."""
    with open(path) as f:
        return _from_dict(Config, json.load(f) or {})
