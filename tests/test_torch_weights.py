"""`state_dict_from_jax` and the port's layers, one module at a time.

JAX modules are initialised, every parameter and batch statistic is then
redrawn from a numpy seed (so BN statistics are not the identity), the trees
go through `state_dict_from_jax`, and the port's module loads them with
`strict=True` and must agree with the JAX module on the same input, in
float32 on the CPU at rtol 1e-4, atol 1e-4 (one module, convolutions summed
in another order). The transposed-conv layouts (SECONDFPN k = s = 1, 2 and
the BEV backbone's k = s = 2) and the head's grouped out conv are covered
here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.layers.bev_backbone import BaseBEVBackbone as JaxBEV
from unidistill_tpu.layers.center_head import CenterHead as JaxHead
from unidistill_tpu.layers.resnet import ResNet as JaxResNet
from unidistill_tpu.layers.second_fpn import SECONDFPN as JaxFPN
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training.torch_import import convert_state_dict

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.layers.bev_backbone import BaseBEVBackbone
from unidistill_torch.layers.center_head import CenterHead
from unidistill_torch.layers.resnet import ResNet
from unidistill_torch.layers.second_fpn import SECONDFPN
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training.jax_weights import state_dict_from_jax

from tests.test_torch_import_full import build_reference_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
PCFG = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")


def randomize(tree, rng, stats=False):
    """Redraw every leaf: He-scaled kernels, BN scale ~1, mild biases and
    statistics."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "kernel" or name == "out_kernel":
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else 9 * shape[3]
            v = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name == "scale":
            v = rng.normal(1, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def port_module(module, params, stats, prefix):
    """Load JAX trees, nested under the model path `prefix`, into `module`."""
    def nest(tree):
        for p in reversed(prefix.split(".")):
            tree = {p: tree}
        return tree
    sd = state_dict_from_jax(nest(params), nest(stats), PCFG)
    sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def init(module, *args, seed=0):
    v = module.init(jax.random.PRNGKey(seed), *args, train=False)
    rng = np.random.RandomState(seed)
    return randomize(v["params"], rng), randomize(v.get("batch_stats", {}), rng, True)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_resnet_matches_jax():
    x = np.random.RandomState(1).randn(2, 32, 64, 3).astype(np.float32)
    jm = JaxResNet(dtype=jnp.float32)
    p, s = init(jm, jnp.asarray(x))
    ref = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    got = port_module(ResNet(), p, s, "camera_encoder.img_backbone")(nchw(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=1e-3, atol=1e-3)


def test_second_fpn_matches_jax():
    cc = PCFG.camera_encoder
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, 8 // 2 ** i * 4, 16 // 2 ** i * 4, c).astype(np.float32)
             for i, c in enumerate(cc.img_neck_in_channels)]
    jm = JaxFPN(cc.img_neck_out_channels, cc.img_neck_upsample_strides, dtype=jnp.float32)
    jf = [jnp.asarray(f) for f in feats]
    p, s = init(jm, jf)
    ref = jm.apply({"params": p, "batch_stats": s}, jf, train=False)
    mod = SECONDFPN(cc.img_neck_in_channels, cc.img_neck_out_channels, cc.img_neck_upsample_strides)
    got = port_module(mod, p, s, "camera_encoder.img_neck")([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_bev_backbone_matches_jax():
    be = PCFG.bev_encoder
    x = np.random.RandomState(3).randn(2, 10, 10, 32).astype(np.float32)
    jm = JaxBEV(be.layer_nums, be.layer_strides, be.num_filters, be.upsample_strides,
                be.num_upsample_filters, dtype=jnp.float32)
    p, s = init(jm, jnp.asarray(x))
    ref, ref_pyr = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    mod = BaseBEVBackbone(32, be.layer_nums, be.layer_strides, be.num_filters,
                          be.upsample_strides, be.num_upsample_filters)
    got, pyr = port_module(mod, p, s, "bev_encoder")(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    assert set(pyr) == set(ref_pyr)
    for k in pyr:
        np.testing.assert_allclose(nhwc(pyr[k]), np.asarray(ref_pyr[k]), **TOL)


def test_center_head_matches_jax():
    x = np.random.RandomState(4).randn(2, 10, 10, 48).astype(np.float32)
    jm = JaxHead(PCFG.tasks, PCFG.det_head.common_heads, dtype=jnp.float32)
    p, s = init(jm, jnp.asarray(x))
    ref = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    mod = CenterHead(48, PCFG.tasks, PCFG.det_head.common_heads)
    got = port_module(mod, p, s, "det_head")(nchw(x))
    for tid, r in enumerate(ref):
        assert set(got[tid]) == set(r)
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(got[tid][name]), np.asarray(v), err_msg=f"{tid}/{name}", **TOL)


def _jax_camera_trees():
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    n = jcfg.camera_encoder.num_cams
    H, W = jcfg.camera_encoder.final_dim
    eye = jnp.broadcast_to(jnp.eye(4), (1, n, 4, 4))
    mats = dict(sensor2ego_mats=eye, intrin_mats=eye, ida_mats=eye, bda_mat=jnp.eye(4)[None])
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(
        jax.random.PRNGKey(0), imgs=jnp.zeros((1, n, H, W, 3)), mats=mats, train=False))
    return shapes["params"], shapes["batch_stats"]


def test_state_dict_covers_the_model_exactly():
    params, stats = _jax_camera_trees()
    rng = np.random.RandomState(5)
    params, stats = randomize(params, rng), randomize(stats, rng)
    sd = state_dict_from_jax(params, stats, PCFG)
    model = BEVFusionCenterHead(PCFG)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    n_bn = len(jax.tree.leaves(stats)) // 2
    assert len(sd) == n_leaves + n_bn  # + one num_batches_tracked per BN
    np.testing.assert_array_equal(model.awl_params.detach().numpy(), params["awl_params"])


def test_reference_checkpoint_round_trip():
    """reference-named state dict -> JAX trees -> port state dict, strict."""
    ref_sd = build_reference_state_dict(jax_tiny_model(), rng=np.random.RandomState(6))
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    params, stats = convert_state_dict(ref_sd, jcfg)
    sd = state_dict_from_jax(params, stats, PCFG)
    BEVFusionCenterHead(PCFG).load_state_dict(sd, strict=True)
    # the head's shared conv carries over unchanged up to the layout
    w = ref_sd["det_head.dense_head.shared_conv.0.weight"]
    np.testing.assert_array_equal(sd["det_head.shared_conv.weight"].numpy(), w)


def test_unknown_leaf_raises():
    with pytest.raises(KeyError):
        state_dict_from_jax({"det_head": {"shared_conv": {"weird": np.zeros(3)}}}, {}, PCFG)
