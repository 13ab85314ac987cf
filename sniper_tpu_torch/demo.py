"""Single-image SNIPER demo on one CUDA device.

Port of the top-level demo.py:44-98 (the reference's demo.py:35-116): a
one-image roidb with a full-image inference crop, detection at every
TEST.SCALES entry at batch 1, aggregation (per-scale valid ranges,
soft-NMS, the per-image cap), and the detections drawn over the image:

  python -m sniper_tpu_torch.demo --cfg configs/sniper_res101_e2e.yml \\
      --im_path img.jpg [--out_path demo_out.jpg] [--set ...] \\
      [--device cuda]

The weights come from ``train.checkpoint.restore_inference_state``: the
training run's checkpoint of TEST.TEST_EPOCH, else ``network.pretrained``,
else the seeded init.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the reference hardcodes the COCO class list (demo.py:63-73)
COCO_CLASSES = [
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass",
    "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
    "chair", "couch", "potted plant", "bed", "dining table", "toilet",
    "tv", "laptop", "mouse", "remote", "keyboard", "cell phone",
    "microwave", "oven", "toaster", "sink", "refrigerator", "book",
    "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
]


def detect(cfg, model, state, im_path: str, device, image_loader=None):
    """Detect in one image: every TEST.SCALES entry at batch 1 through
    ``main_test.make_forward`` (the model's post-NMS roi count at every
    scale, as the JAX demo runs) and the Tester, then ``aggregate``.
    ``state`` is a state_dict to load first (None when ``model`` holds its
    weights); ``image_loader`` replaces cv2.imread. Returns the per-class
    detections of the image, ``final[j]`` [N,5] (x1, y1, x2, y2, score) in
    image pixels, ``final[0]`` the empty background."""
    from sniper_tpu_torch.data.test_loader import (
        TestChipIterator,
        init_inference_crops,
        load_image_cv2,
    )
    from sniper_tpu_torch.infer.tester import Tester
    from sniper_tpu_torch.main_test import make_forward

    image_loader = image_loader or load_image_cv2
    im = image_loader(im_path)
    roidb = [{"image": im_path, "width": im.shape[1], "height": im.shape[0],
              "flipped": False}]
    init_inference_crops(roidb)
    tester = Tester(make_forward(model, state, device,
                                 cfg.network.PIXEL_MEANS),
                    cfg, cfg.dataset.NUM_CLASSES)
    scale_dets = []
    for s in range(len(cfg.TEST.SCALES)):
        batches = TestChipIterator(roidb, cfg, s, 1,
                                   image_loader=image_loader)
        all_boxes, _, _ = tester.get_detections(iter(batches), roidb)
        scale_dets.append(all_boxes)
    final = tester.aggregate(scale_dets, 1)
    return [final[j][0] for j in range(len(final))]


def render(cfg, im_bgr: np.ndarray, final, out_path: str) -> str:
    """Draw the detections scored 0.5 and up over the image (COCO names
    for an 81-class model) and write it to ``out_path``."""
    import cv2

    from sniper_tpu_torch.utils.visualization import draw_detections

    vis = draw_detections(
        cv2.cvtColor(im_bgr, cv2.COLOR_BGR2RGB), final,
        COCO_CLASSES if cfg.dataset.NUM_CLASSES == 81 else None,
        threshold=0.5)
    cv2.imwrite(out_path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
    return out_path


def main(argv=None):
    from sniper_tpu_torch.config import config_name, load_config
    from sniper_tpu_torch.data.test_loader import load_image_cv2
    from sniper_tpu_torch.models.registry import get_model
    from sniper_tpu_torch.train.checkpoint import restore_inference_state

    p = argparse.ArgumentParser(description="SNIPER demo (torch)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--im_path", required=True)
    p.add_argument("--out_path", default="demo_out.jpg")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="overrides", nargs="*", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.cfg, args.overrides)
    im = load_image_cv2(args.im_path)
    model = get_model(cfg)
    restore_inference_state(cfg, model, config_name(args.cfg))
    final = detect(cfg, model, None, args.im_path, torch.device(args.device),
                   image_loader=lambda _: im)
    print(f"wrote {render(cfg, im, final, args.out_path)}")


if __name__ == "__main__":
    main()
