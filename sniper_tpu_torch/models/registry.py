"""Model registry: config symbol -> detector constructor.

Port of sniper_tpu/models/registry.py:73-156: ``resnet_mx_101_e2e``,
``resnet_mx_101_e2e_mask``, ``resnet_mx_50_e2e``, ``resnext_mx_101`` (the
X101 trunk with 64 conv groups) and ``mobilenetv2_e2e`` (the MobileNetV2
trunk, ``head_fc_dim`` 512, the stride of network.RPN_FEAT_STRIDE: 32 in
configs/sniper_mobilenetv2_e2e.yml); TRAIN.WITH_MASK turns the mask branch
on, as in the JAX package. ``TRAIN.bf16`` selects the
trunk's compute dtype, as in the JAX package. The TEST.* RPN keys drive the
inference branch and the TRAIN.* keys the training sampler, whose roi count
per image is TRAIN.RPN_POST_NMS_TOP_N (the reference op emits exactly that
many). ``network.BN_MODE`` is checked as the JAX registry checks it
(``_bn_mode``), and ``network.POOL_KERNEL`` is read as it reads it
(``_pool_kernel``): "pallas" sends the R-CNN head's inference pool through
the patch route (the ROI patch kernel, then torch ops), every other value
through the fused pool kernels; the device of the tensors still decides
between a kernel and its plain version. The JAX registry's multi-device
fallbacks of that key are not ported: a CUDA kernel has no sharding rule to
lack. ``network.RESNEXT_SUPERGROUPS`` is not read: the supergroups of
ResNeXt's block-diagonal 3x3 exist only for the TPU, and here ResNeXt's
grouped 3x3 is one grouped convolution.
"""

from __future__ import annotations

import torch

from sniper_tpu_torch.models.detector import SNIPERDetector
from sniper_tpu_torch.models.norm import BN_MODES


def _bn_mode(cfg) -> str:
    """network.BN_MODE (sniper_tpu/models/registry.py:51-70): "sync" (the
    default) normalizes with the global batch's statistics across the
    data-parallel ranks, "local" with each rank's own (the reference's
    per-GPU BatchNorm). Any other value raises ValueError. The JAX
    registry resolves "local" on one device to "sync"; TrainBatchNorm
    needs no resolving, since both modes are plain batch statistics
    without a group of more than one rank (models/norm.py)."""
    mode = str(getattr(cfg.network, "BN_MODE", "sync"))
    if mode not in BN_MODES:
        raise ValueError(f"network.BN_MODE must be sync|local, got {mode!r}")
    return mode


# network.POOL_KERNEL -> the head's inference pool route. "einsum" and
# "fused" compute the same function in the JAX package
# (tests/test_pallas_fused_pool.py); here both run the fused pool kernels on
# the card and their plain versions on the CPU
_POOL_KERNELS = {"auto": "fused", "fused": "fused", "einsum": "fused",
                 "pallas": "pallas"}


def _pool_kernel(cfg) -> str:
    """network.POOL_KERNEL (sniper_tpu/models/registry.py:15-33) -> the
    R-CNN head's inference pool route: "pallas" is the
    patch route (ops/deform.py:patch_offset_pool, forward only), "auto",
    "fused" and "einsum" the fused route. Any other value raises
    ValueError. Training and the mask pool take the fused route whatever
    the key says (models/detector.py)."""
    pool = str(getattr(cfg.network, "POOL_KERNEL", "auto"))
    if pool not in _POOL_KERNELS:
        raise ValueError(f"network.POOL_KERNEL must be "
                         f"{'|'.join(_POOL_KERNELS)}, got {pool!r}")
    return _POOL_KERNELS[pool]


def _detector(cfg, overrides, **trunk):
    kw = dict(
        num_classes=cfg.dataset.NUM_CLASSES,
        num_anchors=cfg.network.NUM_ANCHORS,
        anchor_ratios=tuple(cfg.network.ANCHOR_RATIOS),
        anchor_scales=tuple(cfg.network.ANCHOR_SCALES),
        feat_stride=cfg.network.RPN_FEAT_STRIDE,
        autofocus=bool(cfg.TRAIN.AUTO_FOCUS or cfg.TEST.AUTO_FOCUS),
        with_mask=bool(cfg.TRAIN.WITH_MASK),
        rpn_only=bool(cfg.TRAIN.ONLY_PROPOSAL),
        dtype=torch.bfloat16 if cfg.TRAIN.bf16 else torch.float32,
        bbox_stds=tuple(cfg.TRAIN.BBOX_STDS),
        bbox_means=tuple(cfg.TRAIN.BBOX_MEANS),
        pre_nms_top_n=int(cfg.TEST.RPN_PRE_NMS_TOP_N),
        post_nms_top_n=int(cfg.TEST.RPN_POST_NMS_TOP_N),
        nms_thresh=float(cfg.TEST.RPN_NMS_THRESH),
        rpn_min_size=float(cfg.TEST.RPN_MIN_SIZE),
        train_pre_nms=int(cfg.TRAIN.RPN_PRE_NMS_TOP_N),
        train_post_nms=int(cfg.TRAIN.RPN_POST_NMS_TOP_N),
        train_nms_thresh=float(cfg.TRAIN.RPN_NMS_THRESH),
        train_min_size=float(cfg.TRAIN.RPN_MIN_SIZE),
        num_rois=int(cfg.TRAIN.RPN_POST_NMS_TOP_N),
        fg_fraction=float(cfg.TRAIN.FG_FRACTION),
        fg_thresh=float(cfg.TRAIN.FG_THRESH),
        bg_thresh_hi=float(cfg.TRAIN.BG_THRESH_HI),
        bg_thresh_lo=float(cfg.TRAIN.BG_THRESH_LO),
        head_margin_bins=int(getattr(cfg.network, "HEAD_MARGIN_BINS", 1)),
        bn_mode=_bn_mode(cfg),
        pool_kernel=_pool_kernel(cfg),
        **trunk,
    )
    kw.update(overrides)
    return SNIPERDetector(**kw)


def _resnet(units, trunk_type="resnet"):
    def build(cfg, **overrides):
        return _detector(cfg, overrides, trunk_type=trunk_type, units=units)

    return build


def _mobilenetv2(cfg, **overrides):
    return _detector(cfg, overrides, trunk_type="mobilenetv2",
                     head_fc_dim=512)


_REGISTRY = {
    "resnet_mx_101_e2e": _resnet((3, 4, 23, 3)),
    "resnet_mx_101_e2e_mask": _resnet((3, 4, 23, 3)),
    "resnet_mx_50_e2e": _resnet((3, 4, 6, 3)),
    "resnext_mx_101": _resnet((3, 4, 23, 3), "resnext"),
    "mobilenetv2_e2e": _mobilenetv2,
}


def list_models():
    return sorted(_REGISTRY)


def get_model(cfg, **overrides):
    name = cfg.symbol
    if name not in _REGISTRY:
        raise KeyError(f"unknown model symbol {name!r}; the port has "
                       f"{list_models()}")
    return _REGISTRY[name](cfg, **overrides)
