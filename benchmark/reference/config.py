"""nuScenes BEV-detection configuration: the reference's copy of the
port's frozen dataclasses, which the configuration files fill field for
field (`harness/spec.build_dataclass` refuses a file that lacks one or adds
one). Torch-free: the values are plain Python, read by the modules at build
time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

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
