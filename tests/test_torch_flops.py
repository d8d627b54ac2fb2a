"""The port's FLOP counter (`unidistill_torch/utils/flops.py`) and registry
(`utils/registry.py`) against the JAX package's.

Closed forms, exact: a matmul 2·M·N·K; a conv and a transposed conv
2 · output elements · Cin/groups · kernel taps (the JAX
`conv_general_dilated` count, which for a transposed conv counts the
products with the dilation's zeros); a sparse conv 2 · N_out · K · Cin ·
Cout, its backward the input gradient's and K6's products.

The tiny camera forward (eval, batch 1; and in train mode with the loss)
against JAX `matmul_flops` of the same configuration (`jax.make_jaxpr`, no compile), op for op, exactly: every
dense conv of the port counts what its JAX conv counts. The two programs
differ in two places, each checked exactly: the CenterHead's fused output
conv is a grouped conv here and a block-diagonal dense conv of G times the
products in the JAX package (its docstring: "spends 42× the minimal"), and
the JAX package's camera geometry multiplies its 4×4 matrices with
`dot_general`s, which the port writes as elementwise products (no product
counted).
"""
import math

import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training.steps import model_inputs as jax_model_inputs
from unidistill_tpu.utils import flops as jax_flops

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.ops import sparse_conv as sc
from unidistill_torch.utils import flops
from unidistill_torch.utils.registry import Registry

from tests.test_torch_sparse_conv import S3, voxel_set, weights

torch.set_num_threads(2)


def test_matmul_closed_form():
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    assert flops.matmul_flops(torch.mm, a, b)["total"] == 2 * 128 * 512 * 256
    assert flops.matmul_flops(lambda x, y: x @ y, a, b)["dot_general"] == 2 * 128 * 512 * 256


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_closed_form(groups):
    conv = torch.nn.Conv2d(16, 32, 3, padding=1, groups=groups)
    x = torch.zeros(2, 16, 8, 8)
    got = flops.matmul_flops(conv, x)
    assert got["conv"] == got["total"] == 2 * (2 * 32 * 8 * 8) * (16 // groups) * 9


def test_transposed_conv_counts_as_jax():
    """2 · output elements · Cin · taps: the JAX count of the dilated conv."""
    deconv = torch.nn.ConvTranspose2d(16, 32, 2, stride=2)
    x = torch.zeros(2, 16, 5, 5)
    assert flops.matmul_flops(deconv, x)["conv"] == 2 * (2 * 32 * 10 * 10) * 16 * 4


def test_backward_counts_the_gradients():
    """A matmul's backward adds the two gradients' products."""
    a = torch.zeros(32, 64, requires_grad=True)
    b = torch.zeros(64, 64, requires_grad=True)
    got = flops.matmul_flops(lambda: (a @ b).sum().backward())
    assert got["total"] == 3 * 2 * 32 * 64 * 64


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 32)])
def test_sparse_conv_closed_form(cin, cout):
    """Forward 2·N_out·K·Cin·Cout; backward adds the input gradient over the
    transposed map (2·N_in·K·Cout·Cin) and K6 (2·N_out·K·Cin·Cout)."""
    _, pst, _ = voxel_set(S3, seed=60)
    nbr = sc.subm_rules(pst)
    n, K = nbr.shape
    x = torch.nn.functional.pad(pst.features, (0, cin - pst.features.shape[1]))
    w = torch.from_numpy(weights(K, cin, cout, 61))
    fwd = flops.matmul_flops(sc.sparse_conv, x, nbr, w)
    assert fwd["sparse_conv"] == fwd["total"] == 2 * n * K * cin * cout

    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    both = flops.matmul_flops(lambda: sc.sparse_conv(xg, nbr, wg).sum().backward())
    assert both["sparse_conv"] == 3 * 2 * n * K * cin * cout


def _jax_tiny_camera_ops():
    """(conv counts, dot_general eqns) of the JAX tiny camera forward."""
    cfg = jax_tiny_model(with_lidar=False)
    model = JaxModel(cfg)
    from __graft_entry__ import _synth_batch
    kw = jax_model_inputs(jax.tree.map(jnp.asarray, _synth_batch(cfg, 1)), cfg, training=False)
    v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), **kw, train=False))
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    fwd = lambda v: model.apply(v, **kw, train=False)["multi_head_features"]
    total = jax_flops.matmul_flops(fwd, v)
    convs, dots = [], []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "conv_general_dilated":
                convs.append(jax_flops._conv_flops(e))
            elif e.primitive.name == "dot_general":
                dots.append(e)
            for p in e.params.values():
                inner = getattr(p, "jaxpr", p)
                if hasattr(inner, "eqns"):
                    walk(inner)
    walk(jax.make_jaxpr(fwd)(v).jaxpr)
    return total, convs, dots


def _head_out_conv_flops():
    """(count of the CenterHead's grouped output conv, its groups G) at the
    tiny camera's BEV grid."""
    cfg = tiny_model(with_lidar=False)
    head = BEVFusionCenterHead(cfg).det_head.out_conv
    G = head.groups
    assert G > 1
    ny, nx = cfg.camera_encoder.bev_hw
    return 2 * (head.out_channels * ny * nx) * (head.in_channels // G) * math.prod(head.kernel_size), G


def test_tiny_camera_forward_counts_as_jax(monkeypatch):
    jax_total, jax_convs, jax_dots = _jax_tiny_camera_ops()
    convs = []
    conv_flop = flops._conv_flop

    def logged(*args, **kwargs):
        convs.append(conv_flop(*args, **kwargs))
        return convs[-1]
    monkeypatch.setattr(flops, "_conv_flop", logged)
    got = flops.model_flops_per_frame(tiny_model(with_lidar=False), device="cpu")
    assert got["sparse_conv"] == 0 and got["total"] == got["conv"] + got["dot_general"]
    assert sum(convs) == got["conv"]

    # the head's fused output conv: grouped here, block-diagonal dense in JAX
    grouped, G = _head_out_conv_flops()
    assert convs.count(grouped) == 1 and jax_convs.count(G * grouped) == 1
    convs.remove(grouped)
    jax_convs.remove(G * grouped)
    assert sorted(convs) == sorted(jax_convs)

    # the JAX geometry's 4×4 products; the port counts no product there
    assert jax_dots and all(tuple(e.invars[1].aval.shape[-2:]) == (4, 4) for e in jax_dots)
    assert got["dot_general"] == 0
    dots = sum(jax_flops._dot_flops(e) for e in jax_dots)
    assert jax_total["total"] == got["total"] - grouped + G * grouped + dots


def test_tiny_camera_train_forward_with_loss_counts_as_jax():
    """`training=True, with_loss=True` against JAX `model_flops_per_frame`
    with the same flags. Neither the train-mode forward (BatchNorm's batch
    statistics) nor the detector loss adds a product on either side, so the
    port counts what its eval forward counts, and the JAX convs differ from
    it only by the head's block-diagonal conv."""
    jax_got = jax_flops.model_flops_per_frame(jax_tiny_model(with_lidar=False), training=True,
                                              with_loss=True)
    cfg = tiny_model(with_lidar=False)
    got = flops.model_flops_per_frame(cfg, training=True, with_loss=True, device="cpu")
    assert got == flops.model_flops_per_frame(cfg, device="cpu")
    assert got["sparse_conv"] == got["dot_general"] == 0
    grouped, G = _head_out_conv_flops()
    assert jax_got["conv"] == got["conv"] - grouped + G * grouped


def test_registry():
    """As the JAX package's test_parity_components.py::test_registry."""
    r = Registry("test")

    @r.register()
    class Foo:
        pass

    assert r.get("Foo") is Foo
    assert "Foo" in r and list(r.keys()) == ["Foo"]
    with pytest.raises(KeyError):
        r.get("Bar")
    with pytest.raises(KeyError, match="already registered"):
        r.register(Foo)
