"""The port's mask detector against the benchmark's plain-torch reference
(benchmark/reference/mask.py), on the CPU in fp32, and the mask branch's
span and roi counter.

The configuration is the benchmark's r101_mask_e2e at one residual unit a
stage (the harness's tiny trunk, benchmark/tests/tiny.py) with its trunk in
fp32 (TRAIN.bf16 off), so that both sides compute the same fp32 function;
the mask head keeps its published widths (256 channels, a 14x14 pool,
28x28 masks, 2 x 80 planes). Both load one seeded state dict
(benchmark/core/masks.py). The program runs through main_test.make_forward
in eval mode, and the Tester decodes it; the reference runs its own trunk,
RPN and proposals, and its head and mask branch on the program's rois and
argmax classes, as the benchmark's check does. Tolerances:

- proposals: the same boxes in the same order to 1e-3 px (the same fp32
  function, summed in another order: a box corner moves by rounding only);
- class probabilities and mask probabilities: 1e-4 absolute (fp32
  convolutions and GEMMs in other orders, through a softmax; a probability
  is bounded by 1, so an absolute tolerance is one of scale);
- decoded boxes: 1e-2 px (the deltas' rounding, times a box of up to a
  hundred pixels, through exp);
- the argmax foreground class: equal wherever the top two classes are
  more than 1e-4 apart.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.core.masks import mask_program_model, mask_reference_model, \
    mask_seeded_weights
from benchmark.reference import compare
from sniper_tpu_torch.infer import tester as ttester
from sniper_tpu_torch.main_test import make_forward
from sniper_tpu_torch.models import detector as det
from sniper_tpu_torch.utils import profiler as tprofiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 17


def tiny_config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "r101_mask_e2e.json")) as f:
        config = json.load(f)
    config["units"] = [1, 1, 1, 1]
    yml = config["yml"]
    yml["TRAIN"]["bf16"] = False
    yml["TEST"].update(RPN_PRE_NMS_TOP_N=200)
    return config


@pytest.fixture(scope="module")
def sides():
    config = tiny_config()
    cpu = torch.device("cpu")
    cfg, model = mask_program_model(config, SEED, cpu)
    model.eval()
    ref = mask_reference_model(config, cpu)
    ref.load_state_dict(mask_seeded_weights(config, SEED, cpu))
    ref.eval()
    return config, cfg, model, ref


def _images(b, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    small = torch.randint(0, 256, (b, 3, h // 8, w // 8), generator=g)
    big = torch.nn.functional.interpolate(small.float(), size=(h, w),
                                          mode="bilinear",
                                          align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


@pytest.mark.parametrize("b,h,w,n", [(2, 96, 128, 16), (1, 64, 96, 8)])
def test_mask_detector_matches_the_reference(sides, b, h, w, n):
    config, cfg, model, ref = sides
    data = _images(b, h, w, b * h + w)
    info = np.array([[h, w, 1.0]] * b, np.float32)
    info[-1, :2] = [h - 8, w - 16]  # one image short of its canvas
    out = make_forward(model, None, torch.device("cpu"),
                       cfg.network.PIXEL_MEANS, post_nms_top_n=n)(data, info)
    assert out["mask_prob"].shape == (b, n, 28, 28)
    scores, boxes, _, masks = ttester.Tester(None, cfg, model.num_classes) \
        .detect_outputs(out, info, [1.0] * b)
    with torch.no_grad():
        r = ref.infer(data, torch.as_tensor(info), n)
        rois = out["rois"]
        cls_prob, bbox = ref.head(r["roi_map"], rois)
        cid = out["cls_prob"][..., 1:].argmax(-1)
        want_masks = ref.mask_prob(r["roi_map"], rois, cid)
    valid = out["roi_valid"]
    assert torch.equal(valid, r["roi_valid"])
    torch.testing.assert_close(rois[valid], r["rois"][valid], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(out["cls_prob"][valid], cls_prob[valid],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out["mask_prob"][valid], want_masks[valid],
                               rtol=0, atol=1e-4)
    top2 = cls_prob[..., 1:].topk(2, dim=-1).values
    clear = valid & (top2[..., 0] - top2[..., 1] > 1e-4)
    assert torch.equal(cid[clear], cls_prob[..., 1:].argmax(-1)[clear])
    for i in range(b):
        s, bx = compare._decode(rois[i].numpy(), cls_prob[i].numpy(),
                                bbox[i].numpy(), valid[i].numpy(), info[i],
                                info[i][2])
        np.testing.assert_allclose(scores[i], s, rtol=0, atol=1e-4)
        v = valid[i].numpy()
        np.testing.assert_allclose(boxes[i][v], bx[v], rtol=0, atol=1e-2)
        np.testing.assert_array_equal(masks[i], out["mask_prob"][i].numpy())


def test_mask_span_and_roi_counter(sides, tmp_path):
    _, cfg, model, _ = sides
    b, n = 2, 12
    fwd = make_forward(model, None, torch.device("cpu"),
                       cfg.network.PIXEL_MEANS, post_nms_top_n=n)
    info = np.array([[64.0, 96.0, 1.0]] * b, np.float32)
    det.MASK_ROIS = -7
    with tprofiler.device_trace(str(tmp_path)):
        fwd(_images(b, 64, 96, 3), info)
    assert det.MASK_ROIS == b * n
    fwd(_images(b, 64, 96, 4), info)
    assert det.MASK_ROIS == b * n  # reset at each forward, not summed
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("sniper/"))
    names = [s for _, _, s in spans]
    assert names == ["sniper/trunk", "sniper/rpn", "sniper/rpn",
                     "sniper/head", "sniper/mask"]
    for (_, end, name), (start, _, nxt) in zip(spans, spans[1:]):
        assert end <= start, (name, nxt)
