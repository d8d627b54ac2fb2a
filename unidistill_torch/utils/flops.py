"""Matrix-product FLOP accounting of the port, the numerator of a share of peak.

Counterpart of the JAX package's `utils/flops.py`, which walks the traced
jaxpr and counts every `dot_general` and `conv_general_dilated` as
2 · output elements · reduction size. Here torch's
`torch.utils.flop_counter.FlopCounterMode` counts the aten ops as the
function runs, with the JAX conventions:

  * mm, addmm, bmm, baddbmm (and what decomposes into them): torch's
    formulas, 2·M·N·K, as a `dot_general`;
  * convolutions, transposed ones too: 2 · output elements · Cin/groups ·
    kernel taps, as a `conv_general_dilated` (JAX writes a transposed conv
    as a conv over the input dilated by its stride, so it counts the
    products with the inserted zeros as well);
  * `unidistill::sparse_conv` (kernel K4): 2 · N_out · K · Cin · Cout, what
    the JAX package's gathered `dot_general` counts; in a backward,
    `unidistill::sparse_conv_dgrad` 2 · N_in · K · Cout · Cin and
    `unidistill::sparse_conv_wgrad` (K6) 2 · N_out · K · Cin · Cout. The port
    counts the real sites of each stage, the JAX package its stage caps;
  * the BEV pool and the NMS: 0, as in the JAX package, where they are not
    `dot_general`s.

The count runs the function: the sparse sizes are data. So it is made on
the CPU at small sizes and on the card at full size (`model_flops_per_frame`
runs on the card unless `device="cpu"` is asked).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# the op registrations the formulas below attach to
from unidistill_torch.ops import sparse_conv as _sparse_conv  # noqa: F401

aten = torch.ops.aten


@register_flop_formula(torch.ops.unidistill.sparse_conv)
def _sparse_conv_flop(features_shape, nbr_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    K, cin, cout = weight_shape
    return 2 * nbr_shape[0] * K * cin * cout


@register_flop_formula(torch.ops.unidistill.sparse_conv_dgrad)
def _sparse_conv_dgrad_flop(g_shape, nbr_t_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    K, cin, cout = weight_shape
    return 2 * nbr_t_shape[0] * K * cout * cin


@register_flop_formula(torch.ops.unidistill.sparse_conv_wgrad)
def _sparse_conv_wgrad_flop(features_shape, g_shape, nbr_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * nbr_shape[0] * nbr_shape[1] * features_shape[1] * g_shape[1]


def _conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation, _transposed, _output_padding,
               groups, *args, out_shape=None, **kwargs) -> int:
    """2 · output elements · Cin/groups · kernel taps (the JAX count)."""
    return 2 * math.prod(out_shape) * (x_shape[1] // groups) * math.prod(w_shape[2:])


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                        transposed, output_padding, groups, output_mask, out_shape=None, **kwargs) -> int:
    """The forward's count for each gradient asked for (input, weight)."""
    fwd = _conv_flop(x_shape, w_shape, None, stride, padding, dilation, transposed, output_padding,
                     groups, out_shape=grad_out_shape)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _counter() -> FlopCounterMode:
    mapping = {aten.convolution: _conv_flop, aten._convolution: _conv_flop,
               aten.convolution_backward: _conv_backward_flop}
    return FlopCounterMode(display=False, custom_mapping=mapping)


def matmul_flops(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Matrix-product FLOPs of one call of `fn(*args, **kwargs)`, which runs.
    Returns {"dot_general": F, "conv": F, "sparse_conv": F, "total": F}:
    the products, the dense convolutions, the sparse convolutions."""
    counter = _counter()
    with counter:
        fn(*args, **kwargs)
    acc = {"dot_general": 0.0, "conv": 0.0, "sparse_conv": 0.0}
    for op, n in counter.get_flop_counts()["Global"].items():
        name = str(op)
        if "unidistill" in name:
            acc["sparse_conv"] += n
        elif "convolution" in name:
            acc["conv"] += n
        else:
            acc["dot_general"] += n
    acc["total"] = sum(acc.values())
    return acc


def model_flops_per_frame(cfg, training: bool = False, batch: int = 1, with_loss: bool = False,
                          device="cuda") -> Dict[str, float]:
    """Matrix-product FLOPs per FRAME of the detector forward (optionally +
    the detector loss), in train or eval mode, on the synthetic batch of
    seed 0 (`serving.synthetic.train_batch`) with the weights of seed 0:
    flops(batch) / batch. The LiDAR encoder's count depends on the clouds'
    sites."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving import synthetic
    from unidistill_torch.serving.predictor import resolve_device
    from unidistill_torch.training.steps import _tensor, detector_loss, model_inputs

    device = resolve_device(device)
    model = BEVFusionCenterHead(cfg)
    model.load_state_dict(synthetic.random_state_dict(cfg, 0))
    model = model.to(device).train(training)
    b = synthetic.train_batch(cfg, cfg, batch, 0)
    kw = model_inputs(b, cfg, device, training=training)

    def fwd():
        out = model(**kw)
        if with_loss:
            return detector_loss(out, _tensor(b["gt_boxes"], device), cfg)[0]
        return out["multi_head_features"]

    with torch.no_grad():
        acc = matmul_flops(fwd)
    return {k: v / batch for k, v in acc.items()}
