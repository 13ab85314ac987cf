"""The detector's floating-point work, counted from its shapes: the
numerator of the ``*_mfu`` metrics.

A frozen copy of the port's count (sniper_tpu_torch/utils/flops.py, PR
14), walking the reference detector's layers, which have the program's
shapes, so that a later change to the program cannot move the yardstick.
What counts, as multiply-adds x 2:

- every convolution: 2 * B * Ho * Wo * Cout * (Cin / groups) * kh * kw;
  the deformable 3x3 of C5 as the dense (ResNet) or grouped (ResNeXt) 3x3
  of the same shape, its offset conv as a conv;
- every linear layer of the R-CNN head, the pool's offset FC among them:
  2 * rows * in * out, the rows being every roi the head pools;
- gathers, NMS, BatchNorm, activations, softmax, decoding, losses: 0.

Training adds, per product, the weight's gradient where the weight trains
(not in FIXED_PARAMS) and the input's gradient where some layer upstream
trains; each is the forward's count again.
"""

from __future__ import annotations

from benchmark.reference.model import ResNetTrunk, is_fixed


def _out(n, k, stride, pad, dilation):
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


class _Tally:
    def __init__(self, batch, trainable):
        self.batch = batch
        self.trainable = trainable
        self.forward = 0
        self.backward = 0

    def trains(self, prefix):
        return any(n == prefix or n.startswith(prefix + ".")
                   for n in self.trainable)

    def product(self, prefix, flops, grad_in):
        weight = self.trains(prefix)
        self.forward += flops
        self.backward += flops * (int(weight) + int(grad_in))
        return grad_in or weight

    def norm(self, prefix, grad):
        return grad or self.trains(prefix)

    def conv(self, prefix, mod, H, W, grad_in):
        kh, kw = mod.kernel_size
        Ho = _out(H, kh, mod.stride[0], mod.padding[0], mod.dilation[0])
        Wo = _out(W, kw, mod.stride[1], mod.padding[1], mod.dilation[1])
        flops = (2 * self.batch * Ho * Wo * mod.out_channels
                 * (mod.in_channels // mod.groups) * kh * kw)
        return Ho, Wo, self.product(prefix, flops, grad_in)

    def grouped3x3(self, prefix, weight, H, W, stride, grad_in):
        Ho, Wo = _out(H, 3, stride, 1, 1), _out(W, 3, stride, 1, 1)
        flops = 2 * self.batch * Ho * Wo * weight.shape[0] * weight.shape[1] * 9
        return Ho, Wo, self.product(prefix, flops, grad_in)

    def linear(self, prefix, mod, rows, grad_in):
        return self.product(prefix, 2 * rows * mod.in_features
                            * mod.out_features, grad_in)


def _stem(t, trunk, H, W):
    g = t.norm("trunk.bn_data", False) if hasattr(trunk, "bn_data") else False
    H, W, g = t.conv("trunk.conv0", trunk.conv0, H, W, g)
    g = t.norm("trunk.bn0", g)
    return _out(H, 3, 2, 1, 1), _out(W, 3, 2, 1, 1), g


def _resnet(t, trunk, H, W):
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


def _resnext(t, trunk, H, W):
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


def detector_flops(model, batch, canvas_hw, rois_per_image, *, train=False,
                   fixed_params=()):
    """(forward, backward) FLOPs of the reference detector ``model`` (on
    any device, the meta device included) over ``batch`` canvases of
    ``canvas_hw`` with ``rois_per_image`` rois in the head."""
    trainable = ({n for n, _ in model.named_parameters()
                  if not is_fixed(n, fixed_params)} if train else set())
    t = _Tally(batch, trainable)
    walk = _resnet if isinstance(model.trunk, ResNetTrunk) else _resnext
    Hf, Wf, gf = walk(t, model.trunk, *canvas_hw)
    _, _, gr = t.conv("rpn.rpn_conv_3x3", model.rpn.rpn_conv_3x3, Hf, Wf, gf)
    t.conv("rpn.rpn_cls_score", model.rpn.rpn_cls_score, Hf, Wf, gr)
    t.conv("rpn.rpn_bbox_pred", model.rpn.rpn_bbox_pred, Hf, Wf, gr)
    _, _, gm = t.conv("conv_new_1", model.conv_new_1, Hf, Wf, gf)
    rows = batch * rois_per_image
    head = model.rcnn
    go = t.linear("rcnn.offset", head.offset, rows, gm)
    g1 = t.linear("rcnn.fc_new_1", head.fc_new_1, rows, gm or go)
    g2 = t.linear("rcnn.fc_new_2", head.fc_new_2, rows, g1)
    t.linear("rcnn.cls_score", head.cls_score, rows, g2)
    t.linear("rcnn.bbox_pred", head.bbox_pred, rows, g2)
    return t.forward, t.backward
