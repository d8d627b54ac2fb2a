"""nuScenes BEV-detection configuration (the port's own copy).

Field for field the same frozen dataclasses as the JAX package's
`configs/nuscenes.py`; tests/test_torch_isolation.py holds the two equal.
Torch-free: the values are plain Python, read by the modules at build time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

POINT_CLOUD_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VOXEL_SIZE = (0.075, 0.075, 0.2)
GRID_SIZE = (1440, 1440, 40)
IMG_DIM = (256, 704)
OUT_SIZE_FACTOR = 8

CLASS_NAMES = (
    "car",
    "truck",
    "construction_vehicle",
    "bus",
    "trailer",
    "barrier",
    "motorcycle",
    "bicycle",
    "pedestrian",
    "traffic_cone",
)

# 6 CenterPoint task groups
TASKS: Tuple[Tuple[str, ...], ...] = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)

# class name -> 1-based label id (column 9 of gt_boxes)
CLASS_TO_IDX = {name: i + 1 for i, name in enumerate(CLASS_NAMES)}


@dataclass(frozen=True)
class ShapeCaps:
    max_points: int = 262144
    max_voxels_train: int = 120000
    max_voxels_eval: int = 160000
    max_points_per_voxel: int = 10
    max_gt_boxes: int = 128


@dataclass(frozen=True)
class LidarEncoderConfig:
    """The sparse encoder's grid and input features. The caps,
    `encoder_impl` and `no_remat_stages` are fixed-shape and memory knobs of
    the JAX package, kept so that the copy matches it: the port's model keeps
    every active site and reads none of them."""

    point_cloud_range: Tuple[float, ...] = POINT_CLOUD_RANGE
    voxel_size: Tuple[float, ...] = VOXEL_SIZE
    grid_size: Tuple[int, ...] = GRID_SIZE
    max_num_points: int = 10
    src_num_point_features: int = 5
    use_num_point_features: int = 5
    map_to_bev_num_features: int = 256
    stage_voxel_caps: Tuple[int, ...] = (98304, 57344, 32768, 32768)
    s0_slot_cap: int = 131072
    stage_col_caps: Tuple[int, ...] = (65536, 49152, 32768, 16384, 16384)
    encoder_impl: str = "chunked"
    no_remat_stages: Tuple[str, ...] = ("res1", "res2", "res3")


@dataclass(frozen=True)
class CameraEncoderConfig:
    x_bound: Tuple[float, float, float] = (-54.0, 54.0, 0.6)
    y_bound: Tuple[float, float, float] = (-54.0, 54.0, 0.6)
    z_bound: Tuple[float, float, float] = (-5.0, 3.0, 8.0)
    d_bound: Tuple[float, float, float] = (2.0, 58.0, 0.5)
    final_dim: Tuple[int, int] = IMG_DIM
    output_channels: int = 256
    downsample_factor: int = 16
    num_cams: int = 6
    img_backbone: str = "resnet50"
    img_neck_in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    img_neck_upsample_strides: Tuple[float, ...] = (0.25, 0.5, 1, 2)
    img_neck_out_channels: Tuple[int, ...] = (128, 128, 128, 128)
    depth_net_in_channels: int = 512
    depth_net_mid_channels: int = 512

    @property
    def depth_channels(self) -> int:
        lo, hi, step = self.d_bound
        return int((hi - lo) / step)  # 112

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return (
            self.final_dim[0] // self.downsample_factor,
            self.final_dim[1] // self.downsample_factor,
        )  # (16, 44)

    @property
    def bev_hw(self) -> Tuple[int, int]:
        nx = round((self.x_bound[1] - self.x_bound[0]) / self.x_bound[2])
        ny = round((self.y_bound[1] - self.y_bound[0]) / self.y_bound[2])
        return (ny, nx)  # (180, 180)


@dataclass(frozen=True)
class BevEncoderConfig:
    layer_nums: Tuple[int, ...] = (5, 5)
    layer_strides: Tuple[int, ...] = (1, 2)
    num_filters: Tuple[int, ...] = (128, 256)
    upsample_strides: Tuple[int, ...] = (1, 2)
    num_upsample_filters: Tuple[int, ...] = (256, 256)
    num_bev_features: int = 256


@dataclass(frozen=True)
class AssignerConfig:
    out_size_factor: int = OUT_SIZE_FACTOR
    dense_reg: int = 1
    gaussian_overlap: float = 0.1
    max_objs: int = 2500
    min_radius: int = 2
    topk: int = 9
    with_velocity: bool = True
    max_pos: int = 1536


@dataclass(frozen=True)
class ProposalConfig:
    post_center_limit_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    score_threshold: float = 0.1
    iou_aware_alpha: Tuple[float, ...] = (0.65,) * 10
    nms_iou_threshold_train: float = 0.8
    nms_pre_max_size_train: int = 1500
    nms_post_max_size_train: int = 80
    nms_iou_threshold_test: float = 0.1
    nms_pre_max_size_test: int = 1500
    nms_post_max_size_test: int = 100
    # only the top-`nms_cap` score-sorted candidates enter the pairwise IoU
    nms_cap: int = 512


@dataclass(frozen=True)
class DetHeadConfig:
    input_channels: int = 512
    share_conv_channel: int = 64
    init_bias: float = -2.19
    code_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    loc_weight: float = 0.25
    iou_weight: float = 5.0
    # name -> (out_channels, num_conv)
    common_heads: Tuple[Tuple[str, Tuple[int, int]], ...] = (
        ("iou", (1, 2)),
        ("reg", (2, 2)),
        ("height", (1, 2)),
        ("dim", (3, 2)),
        ("rot", (2, 2)),
        ("vel", (2, 2)),
    )
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


@dataclass(frozen=True)
class ModelConfig:
    class_names: Tuple[str, ...] = CLASS_NAMES
    tasks: Tuple[Tuple[str, ...], ...] = TASKS
    point_cloud_range: Tuple[float, ...] = POINT_CLOUD_RANGE
    voxel_size: Tuple[float, ...] = VOXEL_SIZE
    grid_size: Tuple[int, ...] = GRID_SIZE
    out_size_factor: int = OUT_SIZE_FACTOR
    with_lidar: bool = True
    with_camera: bool = True
    lidar_encoder: LidarEncoderConfig = field(default_factory=LidarEncoderConfig)
    camera_encoder: CameraEncoderConfig = field(default_factory=CameraEncoderConfig)
    bev_encoder: BevEncoderConfig = field(default_factory=BevEncoderConfig)
    assigner: AssignerConfig = field(default_factory=AssignerConfig)
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    det_head: DetHeadConfig = field(default_factory=DetHeadConfig)
    caps: ShapeCaps = field(default_factory=ShapeCaps)
    # "bfloat16": convolutions in bf16; BN, softmax, pooling and heads in f32
    compute_dtype: str = "bfloat16"

    @property
    def feature_map_size(self) -> Tuple[int, int]:
        return (
            self.grid_size[0] // self.out_size_factor,
            self.grid_size[1] // self.out_size_factor,
        )  # (180, 180)


@dataclass(frozen=True)
class DistillConfig:
    """Cross-modality distillation weights: total = det + w_feature·feature
    + w_rel·bev_rel + w_resp·(resp_cls + resp_reg). The teacher heatmap is
    clamp(sigmoid(hm / teacher_hm_temp), teacher_hm_clamp, 1 - clamp); the
    student's arrives already sigmoided and clamped by its own head loss."""

    teacher: str = "lidar"  # lidar | camera | fusion
    student: str = "camera"
    w_feature: float = 100.0
    w_rel: float = 40.0
    w_resp: float = 10.0
    teacher_hm_temp: float = 2.0
    teacher_hm_clamp: float = 1e-4


# (teacher, student) -> DistillConfig
DISTILL_VARIANTS: Dict[Tuple[str, str], DistillConfig] = {
    ("lidar", "camera"): DistillConfig("lidar", "camera", 100.0, 40.0, 10.0, 2.0, 1e-4),
    ("fusion", "camera"): DistillConfig("fusion", "camera", 10.0, 5.0, 10.0, 2.0, 1e-3),
    ("camera", "lidar"): DistillConfig("camera", "lidar", 10.0, 5.0, 1.0, 2.0, 1e-4),
    ("fusion", "lidar"): DistillConfig("fusion", "lidar", 10.0, 1.0, 10.0, 2.0, 1e-4),
}


@dataclass(frozen=True)
class DataConfig:
    root_path: str = "/data/dataset"
    nusc_version: str = "v1.0-trainval"
    num_lidar_sweeps: int = 10
    num_cam_sweeps: int = 0
    lidar_with_timestamp: bool = True
    use_cbgs: bool = True
    img_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, ...] = (58.395, 57.12, 57.375)
    to_rgb: bool = True
    ida_resize_lim: Tuple[float, float] = (0.386, 0.55)
    ida_rot_lim: Tuple[float, float] = (-5.4, 5.4)
    ida_rand_flip: bool = True
    ida_bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    src_h: int = 900
    src_w: int = 1600
    bda_rot_lim: Tuple[float, float] = (-45.0, 45.0)
    bda_scale_lim: Tuple[float, float] = (0.90, 1.10)
    bda_trans_lim: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    bda_flip_dx_ratio: float = 0.5
    bda_flip_dy_ratio: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    batch_size_per_device: int = 4
    max_epochs: int = 20
    lr: float = 1e-3
    weight_decay: float = 1e-7
    lr_milestones: Tuple[int, ...] = (10, 15)
    lr_gamma: float = 0.1
    grad_clip_value: float = 0.1
    seed: int = 0
    num_keep_latest_ckpt: int = 1
    eval_interval: int = 10
    lr_scale_factor: Optional[Tuple[Tuple[str, float], ...]] = None
    spatial_bev: int = 1


@dataclass(frozen=True)
class ExpConfig:
    exp_name: str = "bevfusion_nuscenes"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    distill: Optional[DistillConfig] = None


def _replace_nested(cfg: Any, path: str, value: Any) -> Any:
    """Functionally set `a.b.c` on nested frozen dataclasses."""
    head, _, rest = path.partition(".")
    if not rest:
        cur = getattr(cfg, head)
        if cur is not None and not isinstance(cur, (dict, type(None))):
            ftype = type(cur)
            if ftype in (int, float, bool, str) and not isinstance(value, ftype):
                value = ftype(value) if ftype is not bool else value in (True, "True", "true", 1)
            elif isinstance(cur, tuple) and not isinstance(value, tuple):
                value = tuple(value)
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(
        cfg, **{head: _replace_nested(getattr(cfg, head), rest, value)}
    )


def apply_overrides(cfg: ExpConfig, overrides: Dict[str, Any]) -> ExpConfig:
    """Apply `--exp_options k.l=v` overrides (ref DictAction, utils/__init__.py:4-93)."""
    for k, v in overrides.items():
        cfg = _replace_nested(cfg, k, v)
    return cfg


def lidar_exp() -> ExpConfig:
    """The LiDAR-only CenterHead experiment (no camera encoder)."""
    return ExpConfig(
        exp_name="BEVFusion_nuscenes_centerhead_lidar_exp",
        model=ModelConfig(
            with_camera=False,
            lidar_encoder=LidarEncoderConfig(
                no_remat_stages=("res1", "res2", "res3", "res4"),
            ),
        ),
    )


def camera_exp() -> ExpConfig:
    """The camera-only CenterHead experiment (no LiDAR encoder; lr 2e-4)."""
    return ExpConfig(
        exp_name="BEVFusion_nuscenes_centerhead_camera_exp",
        model=ModelConfig(with_lidar=False),
        train=TrainConfig(lr=2e-4),
    )


def fusion_exp() -> ExpConfig:
    """The LiDAR + camera fusion CenterHead experiment (every default)."""
    return ExpConfig(exp_name="BEVFusion_nuscenes_centerhead_fusion_exp")


def distill_exp(teacher: str, student: str) -> ExpConfig:
    """A distillation experiment: the student's experiment at lr 2e-4 with
    the pair's weights from `DISTILL_VARIANTS`."""
    dcfg = DISTILL_VARIANTS[(teacher, student)]
    base = camera_exp() if student == "camera" else lidar_exp()
    return dataclasses.replace(
        base,
        exp_name=f"BEVFusion_nuscenes_centerhead_{student}_exp_distill_{teacher}",
        train=dataclasses.replace(base.train, lr=2e-4),
        distill=dcfg,
    )


def tiny_model(with_lidar: bool = True, with_camera: bool = True) -> ModelConfig:
    """Shrunken config for CPU tests: same structure, tiny grid (80×80×8),
    32×64 images, 4 depth bins, small voxel caps."""
    return ModelConfig(
        grid_size=(80, 80, 40),
        voxel_size=(1.35, 1.35, 0.2),
        with_lidar=with_lidar,
        with_camera=with_camera,
        lidar_encoder=LidarEncoderConfig(
            voxel_size=(1.35, 1.35, 0.2),
            grid_size=(80, 80, 40),
            stage_voxel_caps=(1024, 512, 256, 256),
            stage_col_caps=(1024, 512, 256, 256, 256),
        ),
        camera_encoder=CameraEncoderConfig(
            x_bound=(-54.0, 54.0, 10.8),
            y_bound=(-54.0, 54.0, 10.8),
            d_bound=(2.0, 10.0, 2.0),
            final_dim=(32, 64),
            num_cams=2,
            output_channels=256,
        ),
        assigner=AssignerConfig(max_pos=128),
        caps=ShapeCaps(
            max_points=4096, max_voxels_train=2048, max_voxels_eval=2048,
            max_gt_boxes=16,
        ),
    )
