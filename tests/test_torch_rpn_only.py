"""The RPN-only mode (TRAIN.ONLY_PROPOSAL) and proposal extraction of the
port against the JAX package's, on the CPU in fp32.

- The tiny RPN-only detector: ``convert`` of the JAX RPN-only variables is
  complete and strict (no ``conv_new_1``, R-CNN or mask modules on either
  side), and its inference proposals match JAX's (boxes within 1e-3 px,
  scores within close_to_scale's rtol 1e-4).
- One training forward's RPN losses and the trunk's ``dcn_offset_max``
  match JAX's ``total_loss(rpn_only=True)`` on the same batch (rtol 1e-4:
  fp32 convolutions summing in another order); ``make_train_step`` reports
  no R-CNN metric in this mode.
- ``Tester.extract_proposals`` matches JAX's with an injected forward.
- The pkl that ``run_proposal_extraction`` writes reads through both
  packages' ``load_rpn_proposals`` to the same roidb.
- ``restore_inference_state`` takes each of its three branches.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config
from sniper_tpu.data.roidb import load_rpn_proposals as jload
from sniper_tpu.infer.tester import Tester as JTester
from sniper_tpu.models.losses import total_loss as jtotal_loss
from sniper_tpu_torch.convert import convert
from sniper_tpu_torch.data.roidb import load_rpn_proposals
from sniper_tpu_torch.infer.tester import Tester
from sniper_tpu_torch.main_test import run_proposal_extraction
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.models.losses import total_loss
from sniper_tpu_torch.train.checkpoint import (
    restore_inference_state,
    save_checkpoint,
)
from sniper_tpu_torch.train.optimizer import make_optimizer
from sniper_tpu_torch.train.pretrained import mapping_rows, save_mxnet_params
from sniper_tpu_torch.train.trainer import make_train_step
from test_torch_detector import _perturb
from test_torch_train_cli import SynthDataset, make_cfg
from torch_port import TINY, close_to_scale, synth_image_loader, \
    tiny_jax_detector, tiny_torch_detector

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import gen_torch_train_golden as gg  # noqa: E402  the golden step's batch

H, W = 64, 96


@pytest.fixture(scope="module")
def rpn_models():
    rng = np.random.RandomState(17)
    jmodel, variables = tiny_jax_detector(2, rpn_only=True)
    assert set(variables["params"]) == {"trunk", "rpn"}
    variables = _perturb(variables, rng)
    model = tiny_torch_detector(variables, rpn_only=True)  # strict convert
    return jmodel, variables, model


def test_rpn_only_state_is_the_converted_jax_tree(rpn_models):
    _, variables, model = rpn_models
    assert {k.split(".")[0] for k in model.state_dict()} == {"trunk", "rpn"}
    assert set(convert(variables, model)) == set(model.state_dict())


def test_rpn_only_inference_matches_jax(rpn_models):
    jmodel, variables, model = rpn_models
    rng = np.random.RandomState(3)
    data = rng.randn(2, H, W, 3).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 20, 1.0]], np.float32)
    want = jmodel.apply(variables, data, im_info, train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(data), torch.from_numpy(im_info))
    assert set(got) == set(want) == {"rois", "roi_scores", "roi_valid"}
    assert got["rois"].shape == (2, TINY["post_nms_top_n"], 5)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]),
                               atol=1e-3, rtol=1e-5)
    close_to_scale(got["roi_scores"], want["roi_scores"])


def _batch():
    return gg.make_batch(), gg.B


def test_rpn_only_losses_match_jax(rpn_models):
    from sniper_tpu.train.trainer import _collect_sown

    jmodel, variables, model = rpn_models
    batch, B = _batch()
    out, mutated = jmodel.apply(
        variables, batch["data"], batch["im_info"], batch["gt_boxes"],
        batch["valid_ranges"], train=True, mutable=["batch_stats",
                                                    "intermediates"])
    _, want = jtotal_loss(out, batch, batch_images=B, rpn_batch_size=32,
                          rpn_only=True)
    want_dcn = float(np.max(_collect_sown(mutated["intermediates"],
                                          "dcn_offset_max")))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.train()
    got_out = model(tb["data"], tb["im_info"], tb["gt_boxes"],
                    tb["valid_ranges"], train=True)
    model.eval()
    assert set(got_out) == {"rpn_cls_logits", "rpn_bbox_pred", "stats"}
    _, got = total_loss(got_out, tb, B, 32, rpn_only=True)
    assert set(got) == set(want) == {"rpn_cls_loss", "rpn_bbox_loss", "loss"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_out["stats"]["dcn_offset_max"]),
                               want_dcn, rtol=1e-4)


def test_rpn_only_train_step_reports_rpn_metrics(rpn_models):
    _, variables, _ = rpn_models
    model = tiny_torch_detector(variables, rpn_only=True)
    batch, B = _batch()
    opt, sched, _ = make_optimizer(make_cfg(), 10, model)
    step = make_train_step(model, opt, sched, B, rpn_batch_size=32,
                           rpn_only=True)
    before = model.rpn.rpn_cls_score.weight.clone()
    m = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == {"rpn_cls_loss", "rpn_bbox_loss", "loss",
                      "dcn_offset_max"}
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(model.rpn.rpn_cls_score.weight, before)


def _fake_forward(seed, n=7):
    rng = np.random.RandomState(seed)

    def forward(data, im_info):
        b = data.shape[0]
        xy = rng.uniform(0, 60, (b, n, 2))
        rois = np.concatenate([np.zeros((b, n, 1)), xy,
                               xy + rng.uniform(4, 30, (b, n, 2))], -1)
        return {"rois": rois.astype(np.float32),
                "roi_scores": rng.rand(b, n).astype(np.float32),
                "roi_valid": rng.rand(b, n) < 0.7}

    return forward


def test_extract_proposals_matches_jax():
    cfg = default_config()
    cfg.TEST.NMS = -1  # soft-NMS, as the shipped configs
    batches = [{"data": np.zeros((2, 8, 8, 3), np.float32),
                "im_info": np.zeros((2, 3), np.float32),
                "im_ids": np.array([i, i + 1]),
                "im_scales": np.array([1.5, 0.5 + i], np.float32),
                "valid": np.array([True, i < 2])} for i in (0, 2)]
    got = Tester(_fake_forward(4), cfg, 5).extract_proposals(batches, [{}] * 4)
    want = JTester(_fake_forward(4), cfg, 5).extract_proposals(
        batches, [{}] * 4)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert len(got[0][3]) == 0  # image 3 is padding


class _Dataset(SynthDataset):
    num_classes = TINY["num_classes"]


def test_extracted_pkl_reads_to_the_same_roidb(tmp_path, rpn_models):
    _, _, model = rpn_models
    cfg = make_cfg()
    cfg.TEST.NMS = -1
    cfg.TEST.SCALES = [(96, 128), (-1, 96)]
    cfg.TEST.BATCH_IMAGES = [2, 3]
    cfg.TEST.PROPOSAL_SAVE_PATH = str(tmp_path / "props")
    ds = _Dataset()
    path = run_proposal_extraction(cfg, model, None, ds.gt_roidb(), ds,
                                   torch.device("cpu"),
                                   image_loader=synth_image_loader)
    assert path == os.path.join(cfg.TEST.PROPOSAL_SAVE_PATH, "synth_rpn.pkl")
    assert os.listdir(cfg.TEST.PROPOSAL_SAVE_PATH) == ["synth_rpn.pkl"]
    with open(path, "rb") as f:
        boxes = pickle.load(f)["boxes"]
    assert len(boxes) == 3
    for b in boxes:  # both scales' kept rois, stacked
        assert b.shape[1] == 5 and TINY["post_nms_top_n"] < len(b)
        assert b.shape[0] <= 2 * TINY["post_nms_top_n"]
    got = load_rpn_proposals(path, ds.gt_roidb(), ds.num_classes,
                             use_cache=False)
    want = jload(path, ds.gt_roidb(), ds.num_classes, use_cache=False)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    assert all(len(g["boxes"]) > 4 for g in got)  # GT plus proposals


def _restore_cfg(tmp_path):
    cfg = make_cfg()
    cfg.output_path = str(tmp_path / "out")
    cfg.dataset.image_set = "train"
    cfg.TEST.TEST_EPOCH = 2
    return cfg


def test_restore_inference_state_takes_each_branch(tmp_path):
    cfg = _restore_cfg(tmp_path)
    logs = []
    # 3. nothing: the seeded init
    model = tiny_torch_detector(rpn_only=True)
    assert restore_inference_state(cfg, model, "cfg", logs.append) == "init"
    ref = init_detector(tiny_torch_detector(rpn_only=True), seed=0)
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # 2. network.pretrained
    rng = np.random.RandomState(1)
    flat = {mx: rng.randn(*model.state_dict()[k].shape).astype(np.float32)
            for k, mx in mapping_rows(model) if k.startswith("trunk.")}
    save_mxnet_params(str(tmp_path / "backbone-0000.params"), flat)
    cfg.network.pretrained = str(tmp_path / "backbone")
    model = tiny_torch_detector(rpn_only=True)
    assert restore_inference_state(cfg, model, "cfg",
                                   logs.append) == "pretrained"
    np.testing.assert_array_equal(model.trunk.conv0.weight.detach().numpy(),
                                  flat["conv0_weight"])
    # 1. the run's checkpoint of TEST_EPOCH, over the pretrained file
    trained = init_detector(tiny_torch_detector(rpn_only=True), seed=9)
    ckpt = os.path.join(cfg.output_path, "cfg", "train", "checkpoints")
    save_checkpoint(ckpt, 2, trained)
    save_checkpoint(ckpt, 3, init_detector(
        tiny_torch_detector(rpn_only=True), seed=10))
    model = tiny_torch_detector(rpn_only=True)
    assert restore_inference_state(cfg, model, "cfg",
                                   logs.append) == "checkpoint"
    for k, v in trained.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert any("epoch 2" in m for m in logs)
    # a checkpoint of another topology fails loudly
    with pytest.raises(RuntimeError, match="conv_new_1"):
        restore_inference_state(cfg, tiny_torch_detector(), "cfg",
                                logs.append)
