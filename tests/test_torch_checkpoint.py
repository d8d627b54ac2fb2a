"""The port's checkpoints (`training/checkpoint.py`), the resume path of its
`Trainer`, and the import of reference PyTorch checkpoints
(`training/torch_import.py`) against the JAX package's importer composed
with `jax_weights.state_dict_from_jax` (numpy on the JAX side; no JAX step
is compiled)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from unidistill_tpu.configs.nuscenes import fusion_exp as jax_fusion_exp, tiny_model as jax_tiny_model
from unidistill_tpu.training.checkpoint import shape_filtered_merge as jax_shape_filtered_merge
from unidistill_tpu.training.torch_import import convert_state_dict as jax_convert_state_dict

from unidistill_torch.configs.nuscenes import ExpConfig, TrainConfig, fusion_exp, tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.serving.synthetic import small_batch, train_batch
from unidistill_torch.training import checkpoint as ckpt_lib
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.loop import Trainer, init_params
from unidistill_torch.training.torch_import import convert_state_dict, load_torch_checkpoint
from unidistill_torch.training.train_state import make_optimizer

from tests.test_torch_import_full import build_reference_state_dict
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)


def _stepped_model(seed=0):
    """A tiny camera detector and its optimizer after one update from
    seeded random gradients (Adam's moments nonzero)."""
    model = init_params(BEVFusionCenterHead(tiny_model(with_lidar=False)), seed)
    opt = make_optimizer(model, TrainConfig())
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step(0)
    return model, opt


def _camera_batch(cfg, seed=3):
    boxes = train_batch(cfg, tiny_model(with_camera=False), 2, seed=23)["gt_boxes"]
    return dict(small_batch(cfg, 2, seed=seed), gt_boxes=boxes)


def _assert_state_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_state_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_save_restore_roundtrip(tmp_path):
    model, opt = _stepped_model()
    ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 7, model, opt)
    path = ckpt_lib.latest_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith("step_7")
    restored = ckpt_lib.restore_checkpoint_any(path)
    assert restored["step"] == 7
    _assert_state_equal(restored["model"], model.state_dict())
    _assert_state_equal(restored["optimizer"]["state"], opt.state_dict()["state"])
    fresh = make_optimizer(BEVFusionCenterHead(tiny_model(with_lidar=False)), TrainConfig())
    fresh.load_state_dict(restored["optimizer"])
    _assert_state_equal(fresh.state_dict()["state"], opt.state_dict()["state"])
    # without an optimizer: the model only
    ckpt_lib.save_checkpoint(str(tmp_path / "teacher"), 0, model)
    assert set(ckpt_lib.restore_checkpoint_any(str(tmp_path / "teacher"))) == {"step", "model"}


def test_keep_latest_prunes(tmp_path):
    model = BEVFusionCenterHead(tiny_model(with_lidar=False))
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        ckpt_lib.save_checkpoint(d, s, model, keep_latest=2)
    assert sorted(os.listdir(d)) == ["step_3", "step_4"]


def test_restore_from_the_parent_dir_and_bad_paths(tmp_path):
    model = BEVFusionCenterHead(tiny_model(with_lidar=False))
    d = tmp_path / "ckpt"
    for s in (2, 10):
        with torch.no_grad():
            model.awl_params.fill_(s)
        ckpt_lib.save_checkpoint(str(d), s, model)
    restored = ckpt_lib.restore_checkpoint_any(str(d))
    assert restored["step"] == 10 and torch.equal(restored["model"]["awl_params"], torch.full((12,), 10.0))
    assert ckpt_lib.restore_checkpoint_any(str(d / "step_2"))["step"] == 2
    (tmp_path / "empty").mkdir()
    for bad in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(ValueError):
            ckpt_lib.restore_checkpoint_any(str(bad))
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "missing")) is None


def test_save_is_idempotent(tmp_path):
    model = BEVFusionCenterHead(tiny_model(with_lidar=False))
    d = str(tmp_path / "ckpt")
    ckpt_lib.save_checkpoint(d, 5, model)
    before = os.stat(os.path.join(d, "step_5", ckpt_lib.STATE_FILE)).st_mtime_ns
    with torch.no_grad():
        model.awl_params.fill_(3.0)
    ckpt_lib.save_checkpoint(d, 5, model)  # fit saves each epoch, the CLI again at exit
    assert os.stat(os.path.join(d, "step_5", ckpt_lib.STATE_FILE)).st_mtime_ns == before
    assert torch.equal(ckpt_lib.restore_checkpoint_any(d)["model"]["awl_params"], torch.ones(12))


def test_shape_filtered_merge_counts_match_jax():
    rng = np.random.RandomState(0)
    target = {"enc.conv.kernel": rng.randn(3, 4), "enc.conv.bias": rng.randn(4), "bn.scale": rng.randn(2),
              "bn.bias": rng.randn(2), "head.w": rng.randn(5, 5)}
    loaded = {"enc.conv.kernel": rng.randn(3, 4), "enc.conv.bias": rng.randn(5),  # wrong shape
              "bn.scale": rng.randn(2), "extra.w": rng.randn(1)}  # bn.bias, head.w missing
    merged, used, skipped = ckpt_lib.shape_filtered_merge(
        {k: torch.from_numpy(v) for k, v in target.items()}, {k: torch.from_numpy(v) for k, v in loaded.items()})

    j_merged, j_used, j_skipped = jax_shape_filtered_merge(_nest(target), _nest(loaded))
    assert (used, skipped) == (j_used, j_skipped) == (2, 3)
    for k, v in merged.items():
        leaf = j_merged
        for part in k.split("."):
            leaf = leaf[part]
        np.testing.assert_array_equal(v.numpy(), np.asarray(leaf), err_msg=k)


def _nest(flat):
    """{"a.b.c": v} -> {"a": {"b": {"c": v}}}, the JAX tree of the names."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


class _TamedTrainer(Trainer):
    """BatchNorm scales × 0.3 and biases + 1 after the seeded init: keeps
    the random BN-ReLU net out of its chaotic regime (chip_smoke.tame)."""

    def init_state(self, steps_per_epoch):
        state = super().init_state(steps_per_epoch)
        with torch.no_grad():
            for m in self.model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.weight.mul_(0.3)
                    m.bias.add_(1.0)
        return state


def test_resumed_training_equals_uninterrupted(tmp_path):
    """A tiny camera detector on the CPU: two epochs of one step each,
    against one epoch, a checkpoint, and a resumed second epoch. The model
    (weights and BatchNorm statistics) and the optimizer's moments are
    bit-equal at the end."""
    cfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    exp = ExpConfig(exp_name="resume", model=cfg, train=TrainConfig(lr=2e-4, seed=4))
    loader = [_camera_batch(cfg)]

    def run(name, epochs, resume=None):
        tr = _TamedTrainer(exp, output_dir=str(tmp_path / name), device="cpu")
        state = tr.fit(loader, epochs, resume_from=resume)
        tr.close()
        return tr, state

    whole, s_whole = run("whole", 2)
    first, _ = run("first", 1)
    resumed, s_resumed = run("resumed", 2, resume=str(tmp_path / "first" / "ckpt"))
    assert s_whole.step == s_resumed.step == 2
    assert sorted(os.listdir(tmp_path / "resumed" / "ckpt")) == ["step_2"]
    _assert_state_equal(resumed.model.state_dict(), whole.model.state_dict())
    _assert_state_equal(resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"])
    assert not all(torch.equal(a, b) for a, b in zip(first.model.state_dict().values(),
                                                      whole.model.state_dict().values()))


REFERENCE_CFGS = {
    "fusion": (fusion_exp().model, jax_fusion_exp().model),
    "tiny_fusion": (tiny_model(), jax_tiny_model()),
    "tiny_camera": (tiny_model(with_lidar=False), jax_tiny_model(with_lidar=False)),
    "tiny_lidar": (tiny_model(with_camera=False), jax_tiny_model(with_camera=False)),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_CFGS))
def test_reference_state_dict_import_matches_jax(name, tmp_path):
    """A reference state dict with every name of the fusion model (random
    values at the configuration's shapes): the port's direct map equals the
    JAX importer followed by `state_dict_from_jax` tensor for tensor, and
    the port's detector loads it strictly."""
    cfg, jcfg = REFERENCE_CFGS[name]
    sd = build_reference_state_dict(jax_tiny_model() if name != "fusion" else jcfg,
                                    rng=np.random.RandomState(11))
    sd = dict(sd)
    params, stats = jax_convert_state_dict(sd, jcfg)
    want = state_dict_from_jax(params, stats, cfg)
    got = convert_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    BEVFusionCenterHead(cfg).load_state_dict(got, strict=True)
    if name == "tiny_fusion":  # the same through a .pth file
        torch.save({"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
                   tmp_path / "ref.pth")
        for k, v in load_torch_checkpoint(str(tmp_path / "ref.pth"), cfg).items():
            assert torch.equal(v, want[k]), k


def test_swin_backbone_is_not_ported():
    cfg = tiny_model()
    cfg = dataclasses.replace(cfg, camera_encoder=dataclasses.replace(cfg.camera_encoder, img_backbone="swin"))
    with pytest.raises(NotImplementedError):
        convert_state_dict({"camera_encoder.backbone.img_backbone.patch_embed.projection.weight":
                            torch.zeros(1)}, cfg)
