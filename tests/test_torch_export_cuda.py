"""The serving export on the card: the tiny fusion detector exported on CUDA
(K1-K4 as the custom ops `unidistill::*`), saved, loaded and run against the
live `Detector.predict` on two batches with other site counts.

Marked `cuda`: skips without an NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_export_cuda.py -m cuda

Expected bit for bit: the program runs the same kernels and aten ops as the
live detector (cuDNN benchmarking off, eval BatchNorm without cuDNN in
both); masks and labels must be equal, boxes and scores equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.kernels import build
from unidistill_torch.serving import synthetic
from unidistill_torch.serving.export import export_detector, load_detector
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.training.steps import model_inputs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fusion_export_on_the_card_predicts_as_detector(cuda_device, tmp_path):
    cfg = tiny_model()
    cfg = dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal, score_threshold=0.0))
    batches = [synthetic.train_batch(cfg, cfg, 2, seed) for seed in (5, 6)]
    det = Detector(cfg, synthetic.random_state_dict(cfg, seed=4), device=cuda_device)
    synthetic.calibrate_batchnorm(det.model, model_inputs(batches[0], cfg, cuda_device, training=False))
    export_detector(cfg, det.model.state_dict(), str(tmp_path), batch_size=2, device=cuda_device)
    loaded = load_detector(str(tmp_path))
    assert loaded.meta["platforms"] == ["cuda"]
    for batch in batches:
        build.reset_launches()
        got = loaded.predict(batch)
        launches = dict(build.LAUNCHES)
        build.reset_launches()
        ref = {k: v.cpu().numpy() for k, v in det.predict(batch).items()}
        assert launches == dict(build.LAUNCHES) and launches["sparse_conv_fwd"] == 21
        assert launches["bev_pool_fwd"] == launches["rotated_iou_mask"] == launches["nms_greedy_select"] == 1
        assert ref["mask"].sum() > 0
        for k in ref:
            assert np.array_equal(got[k], ref[k]), k
