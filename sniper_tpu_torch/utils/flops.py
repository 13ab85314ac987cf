"""The detector's floating-point work, counted from its shapes.

The numerator of the bench's MFU (sniper_tpu_torch/bench.py), in place of
the XLA cost analysis that the JAX bench reads (bench.py:213-231,365-373).
Torch has no cost analysis, and a FlopCounterMode over a forward would see
neither the hand kernels (ctypes calls) nor the same products on both
routes: the plain versions do their gathers as matmuls. So the count walks
the model's layers with the canvas, batch and roi count, and reads nothing
but their shapes: it is the same number on the card and on the CPU, on the
kernel route and the plain one, and a later kernel or fused GEMM does not
move it. What counts, as multiply-adds x 2:

- every convolution: 2 * B * Ho * Wo * Cout * (Cin / groups) * kh * kw;
  the deformable 3x3 of C5 as the dense (ResNet) or grouped (ResNeXt) 3x3
  of the same shape, its offset conv as a conv;
- every linear layer of the R-CNN head, the pool's offset FC among them:
  2 * rows * in * out, the rows being every roi the head pools (B x the
  post-NMS count at inference, B x num_rois in training);
- the hand kernels' gathers (the im2col and its backward, the pool's
  passes and their transposes), NMS, BatchNorm, activations, softmax,
  box decoding and the losses: 0.

Training adds, per product, what autograd runs: the weight's gradient
where the weight trains (not in ``fixed_params``, the config's
network.FIXED_PARAMS), and the input's gradient where some layer upstream
of it trains, BatchNorms included; each is the forward's product count
again. The frozen stem and stage 1 (FIXED_PARAMS conv0, bn0, stage1,
bn_data) run no backward, and the products that read stage 1's output
directly (ResNeXt's first conv1 and shortcut of stage 2) none for their
input. The offset FC that the pool's backward recomputes is not counted:
the count is the model's work, not the hardware's.
"""

from __future__ import annotations

from torch import nn

from sniper_tpu_torch.train.optimizer import is_fixed


def _out(n: int, k: int, stride: int, pad: int, dilation: int) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


class _Tally:
    """Forward and backward FLOPs over a walk of the layers; each product
    is told whether its input needs a gradient and says whether its
    output does."""

    def __init__(self, batch: int, trainable: set):
        self.batch = batch
        self.trainable = trainable
        self.forward = 0
        self.backward = 0

    def trains(self, prefix: str) -> bool:
        return any(n == prefix or n.startswith(prefix + ".")
                   for n in self.trainable)

    def product(self, prefix: str, flops: int, grad_in: bool) -> bool:
        weight = self.trains(prefix)
        self.forward += flops
        self.backward += flops * (int(weight) + int(grad_in))
        return grad_in or weight

    def norm(self, prefix: str, grad: bool) -> bool:
        return grad or self.trains(prefix)

    def conv(self, prefix: str, mod: nn.Conv2d, H: int, W: int,
             grad_in: bool) -> tuple[int, int, bool]:
        kh, kw = mod.kernel_size
        Ho = _out(H, kh, mod.stride[0], mod.padding[0], mod.dilation[0])
        Wo = _out(W, kw, mod.stride[1], mod.padding[1], mod.dilation[1])
        flops = (2 * self.batch * Ho * Wo * mod.out_channels
                 * (mod.in_channels // mod.groups) * kh * kw)
        return Ho, Wo, self.product(prefix, flops, grad_in)

    def grouped3x3(self, prefix: str, weight, H: int, W: int, stride: int,
                   grad_in: bool) -> tuple[int, int, bool]:
        """A 3x3 conv of the OIHW ``weight`` [Cout, Cin/groups, 3, 3] at
        padding 1 (or a deformable 3x3, 'same' at stride 1)."""
        Ho, Wo = _out(H, 3, stride, 1, 1), _out(W, 3, stride, 1, 1)
        flops = 2 * self.batch * Ho * Wo * weight.shape[0] * weight.shape[1] * 9
        return Ho, Wo, self.product(prefix, flops, grad_in)

    def linear(self, prefix: str, mod: nn.Linear, rows: int,
               grad_in: bool) -> bool:
        flops = 2 * rows * mod.in_features * mod.out_features
        return self.product(prefix, flops, grad_in)


def _stem(t: _Tally, trunk, H: int, W: int) -> tuple[int, int, bool]:
    """conv0 (after bn_data where the trunk has it), bn0, max-pool 3x3/2."""
    g = t.norm("trunk.bn_data", False) if hasattr(trunk, "bn_data") else False
    H, W, g = t.conv("trunk.conv0", trunk.conv0, H, W, g)
    g = t.norm("trunk.bn0", g)
    return _out(H, 3, 2, 1, 1), _out(W, 3, 2, 1, 1), g


def _resnet(t: _Tally, trunk, H: int, W: int) -> tuple[int, int, bool]:
    """Pre-activation bottlenecks (models/resnet.py): the shortcut conv
    reads act1, the deformable C5 reads act2 and the offsets."""
    H, W, g = _stem(t, trunk, H, W)
    for i, n in enumerate(trunk.units):
        for j in range(n):
            p = f"trunk.stage{i + 1}_unit{j + 1}"
            u = getattr(trunk, p.split(".")[1])
            g1 = t.norm(f"{p}.bn1", g)
            H1, W1, ga = t.conv(f"{p}.conv1", u.conv1, H, W, g1)
            ga = t.norm(f"{p}.bn2", ga)
            if u.deform:
                _, _, go = t.conv(f"{p}.offset", u.offset, H1, W1, ga)
                H2, W2, gb = t.grouped3x3(f"{p}.conv2_weight", u.conv2_weight,
                                          H1, W1, 1, ga or go)
            else:
                H2, W2, gb = t.conv(f"{p}.conv2", u.conv2, H1, W1, ga)
            gb = t.norm(f"{p}.bn3", gb)
            H3, W3, gc = t.conv(f"{p}.conv3", u.conv3, H2, W2, gb)
            gs = t.conv(f"{p}.sc", u.sc, H, W, g1)[2] if u.sc is not None \
                else g
            H, W, g = H3, W3, gc or gs
    return H, W, g


def _resnext(t: _Tally, trunk, H: int, W: int) -> tuple[int, int, bool]:
    """Post-activation units (models/resnext.py): conv1 and the shortcut
    read the unit's input; the grouped 3x3 carries the stride, and in C5 is
    deformable."""
    H, W, g = _stem(t, trunk, H, W)
    for i, n in enumerate(trunk.units):
        for j in range(n):
            p = f"trunk.stage{i + 1}_unit{j + 1}"
            u = getattr(trunk, p.split(".")[1])
            H1, W1, ga = t.conv(f"{p}.conv1", u.conv1, H, W, g)
            ga = t.norm(f"{p}.bn1", ga)
            if u.deform:
                _, _, go = t.conv(f"{p}.offset", u.offset, H1, W1, ga)
                H2, W2, gb = t.grouped3x3(f"{p}.conv2_weight", u.conv2_weight,
                                          H1, W1, 1, ga or go)
            else:
                H2, W2, gb = t.grouped3x3(f"{p}.conv2_weight", u.conv2_weight,
                                          H1, W1, u.stride, ga)
            gb = t.norm(f"{p}.bn2", gb)
            H3, W3, gc = t.conv(f"{p}.conv3", u.conv3, H2, W2, gb)
            gc = t.norm(f"{p}.bn3", gc)
            if u.sc is not None:
                gs = t.norm(f"{p}.sc_bn", t.conv(f"{p}.sc", u.sc, H, W, g)[2])
            else:
                gs = g
            H, W, g = H3, W3, gc or gs
    return H, W, g


def _mobilenetv2(t: _Tally, trunk, H: int, W: int) -> tuple[int, int, bool]:
    """first_conv, the inverted residuals (expand, depthwise, linear; the
    repeated blocks add their input), last_conv."""

    def unit(p, mu, H, W, g):
        H, W, g = t.conv(f"{p}.conv2d", mu.conv2d, H, W, g)
        return H, W, t.norm(f"{p}.batchnorm", g)

    H, W, g = unit("trunk.first_conv", trunk.first_conv, H, W, False)
    for name, block in trunk.named_children():
        if not name.startswith("seq"):
            continue
        p = f"trunk.{name}"
        Hb, Wb, gb = unit(f"{p}.exp", block.exp, H, W, g)
        Hb, Wb, gb = unit(f"{p}.depthwise", block.depthwise, Hb, Wb, gb)
        Hb, Wb, gb = unit(f"{p}.linear", block.linear, Hb, Wb, gb)
        H, W, g = Hb, Wb, gb or (g if block.shortcut else False)
    return unit("trunk.last_conv", trunk.last_conv, H, W, g)


_TRUNKS = {"resnet": _resnet, "resnext": _resnext,
           "mobilenetv2": _mobilenetv2}


def flops_by_part(model, batch: int, canvas_hw, rois_per_image: int, *,
                  train: bool = False, fixed_params=()) -> dict:
    """{part: (forward, backward) FLOPs} of ``model`` (a box SNIPERDetector,
    on any device, the meta device included: only its layers' shapes are
    read) over ``batch`` canvases of ``canvas_hw`` with ``rois_per_image``
    rois in the R-CNN head; the parts are the model's children "trunk",
    "rpn", and without ``rpn_only`` "conv_new_1" and "rcnn", with the
    FocusPixel head "autofocus". ``train`` counts the backward of a
    training step whose frozen parameters are ``fixed_params`` (module
    doc); inference has none."""
    if model.with_mask:
        raise ValueError("flops_by_part counts the box detector; the mask "
                         "branch is not counted")
    trainable = ({n for n, _ in model.named_parameters()
                  if not is_fixed(n, fixed_params)} if train else set())
    t = _Tally(batch, trainable)
    parts = {}

    def part(name):
        parts[name] = (t.forward - sum(f for f, _ in parts.values()),
                       t.backward - sum(b for _, b in parts.values()))

    Hf, Wf, gf = _TRUNKS[model.trunk_type](t, model.trunk, *canvas_hw)
    part("trunk")
    _, _, gr = t.conv("rpn.rpn_conv_3x3", model.rpn.rpn_conv_3x3, Hf, Wf, gf)
    t.conv("rpn.rpn_cls_score", model.rpn.rpn_cls_score, Hf, Wf, gr)
    t.conv("rpn.rpn_bbox_pred", model.rpn.rpn_bbox_pred, Hf, Wf, gr)
    part("rpn")
    if not model.rpn_only:
        _, _, gm = t.conv("conv_new_1", model.conv_new_1, Hf, Wf, gf)
        part("conv_new_1")
        rows = batch * rois_per_image
        head = model.rcnn
        go = t.linear("rcnn.offset", head.offset, rows, gm)
        g1 = t.linear("rcnn.fc_new_1", head.fc_new_1, rows, gm or go)
        g2 = t.linear("rcnn.fc_new_2", head.fc_new_2, rows, g1)
        t.linear("rcnn.cls_score", head.cls_score, rows, g2)
        t.linear("rcnn.bbox_pred", head.bbox_pred, rows, g2)
        part("rcnn")
    if model.with_autofocus:
        af = model.autofocus
        _, _, ga = t.conv("autofocus.conv_new_2", af.conv_new_2, Hf, Wf, gf)
        _, _, ga = t.conv("autofocus.conv_new_3", af.conv_new_3, Hf, Wf, ga)
        t.conv("autofocus.conv_new_out", af.conv_new_out, Hf, Wf, ga)
        part("autofocus")
    return parts


def detector_flops(model, batch: int, canvas_hw, rois_per_image: int, *,
                   train: bool = False, fixed_params=()) -> tuple[int, int]:
    """(forward, backward) FLOPs of the whole detector (flops_by_part)."""
    parts = flops_by_part(model, batch, canvas_hw, rois_per_image,
                          train=train, fixed_params=fixed_params).values()
    return sum(f for f, _ in parts), sum(b for _, b in parts)
