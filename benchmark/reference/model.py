"""The reference detector: SNIPER's R101 and X101 box detectors in plain
fp32 PyTorch.

A frozen copy of the port's model (pre-activation ResNet with a deformable,
dilated C5; ResNeXt with 64 groups and a deformable C5; the RPN; the
two-pass deformable R-CNN head; the box losses), written to import nothing
of the port, so that the benchmark's verdict does not move when the
program does. Module and parameter names are the port's, so that one state
dict loads into both. Every tensor is fp32: the trunk's bf16 of the
program is the departure that the comparison measures.

``precision`` "fp8" is the control (benchmark/reference/README in
PERF.md): every trunk conv rounds its input and weight to float8_e4m3
with a per-tensor scale in the forward, and its output gradient to
float8_e5m2 in the backward, then computes in fp32; the fp8 of a
tensor-core product that accumulates in fp32. Where the trunk of the
program runs bf16, this is the next precision down.
"""

from __future__ import annotations

import contextlib
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops

BN_EPS = 2e-5
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round8(t, dtype, top):
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


def conv(mod, x, fp8=False, weight=None):
    w = mod.weight if weight is None else weight
    if fp8:
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    return F.conv2d(x, w, mod.bias, mod.stride, mod.padding, mod.dilation,
                    mod.groups)


class FrozenBN(nn.Module):
    def __init__(self, n, use_scale=True):
        super().__init__()
        if use_scale:
            self.weight = nn.Parameter(torch.ones(n))
        else:
            self.register_parameter("weight", None)
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


class TrainBN(FrozenBN):
    """Batch statistics (biased variance) in training mode; the running
    statistics otherwise. The running update is not followed: no compared
    quantity reads it."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                       True, 0.0, BN_EPS)[0]


class _Trunk(nn.Module):
    fp8 = False

    def c(self, mod, x, weight=None):
        return conv(mod, x, self.fp8, weight)


class PreActBottleneck(_Trunk):
    def __init__(self, cin, filters, *, stride, dim_match, dilation, deform,
                 fix_bn):
        super().__init__()
        mid = filters // 4
        self.dilation = dilation
        self.deform = deform
        bn = FrozenBN if fix_bn else TrainBN
        self.bn1 = bn(cin)
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn2 = bn(mid)
        if deform:
            self.offset = nn.Conv2d(mid, 72, 3, padding=2, dilation=2)
            self.conv2_weight = nn.Parameter(torch.zeros(mid, mid, 3, 3))
        else:
            self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   bias=False)
        self.bn3 = bn(mid)
        self.conv3 = nn.Conv2d(mid, filters, 1, bias=False)
        self.sc = (None if dim_match else
                   nn.Conv2d(cin, filters, 1, stride=stride, bias=False))

    def forward(self, x):
        act1 = F.relu(self.bn1(x))
        act2 = F.relu(self.bn2(self.c(self.conv1, act1)))
        if self.deform:
            off = self.c(self.offset, act2)
            w = _Fp8.apply(self.conv2_weight) if self.fp8 else \
                self.conv2_weight
            a = _Fp8.apply(act2) if self.fp8 else act2
            h = ops.deformable_conv(
                a.permute(0, 2, 3, 1).contiguous(),
                off.permute(0, 2, 3, 1).contiguous(), w,
                dilation=self.dilation).permute(0, 3, 1, 2)
        else:
            h = self.c(self.conv2, act2)
        h = self.c(self.conv3, F.relu(self.bn3(h)))
        return h + (x if self.sc is None else self.c(self.sc, act1))


class ResNetTrunk(_Trunk):
    def __init__(self, units=(3, 4, 23, 3)):
        super().__init__()
        filters = (64, 256, 512, 1024, 2048)
        self.units = tuple(units)
        self.out_channels = filters[3] + filters[4]
        self.bn_data = FrozenBN(3, use_scale=False)
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = FrozenBN(64)
        cin = 64
        for i in range(4):
            for j in range(self.units[i]):
                first = j == 0
                self.add_module(f"stage{i + 1}_unit{j + 1}", PreActBottleneck(
                    cin, filters[i + 1],
                    stride=2 if first and i in (1, 2) else 1,
                    dim_match=not first, dilation=2 if i == 3 else 1,
                    deform=i == 3, fix_bn=i == 0))
                cin = filters[i + 1]

    def early(self):
        return [self.bn_data, self.conv0, self.bn0] + [
            getattr(self, f"stage1_unit{j + 1}") for j in range(self.units[0])]

    def forward(self, x):
        frozen = not any(p.requires_grad for m in self.early()
                         for p in m.parameters())
        with torch.no_grad() if frozen else contextlib.nullcontext():
            h = F.relu(self.bn0(self.c(self.conv0, self.bn_data(x))))
            h = F.max_pool2d(h, 3, stride=2, padding=1)
            for j in range(self.units[0]):
                h = getattr(self, f"stage1_unit{j + 1}")(h)
        c4 = None
        for i in range(1, 4):
            if i == 3:
                c4 = h
            for j in range(self.units[i]):
                h = getattr(self, f"stage{i + 1}_unit{j + 1}")(h)
        return torch.cat([c4, h], dim=1)


class ResNeXtUnit(_Trunk):
    def __init__(self, cin, f, *, stride, dim_match, fix_bn, deform,
                 groups=64):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.deform = deform
        bn = FrozenBN if fix_bn else TrainBN
        self.conv1 = nn.Conv2d(cin, f, 1, bias=False)
        self.bn1 = bn(f)
        if deform:
            self.offset = nn.Conv2d(f, 72, 3, padding=2, dilation=2)
        self.conv2_weight = nn.Parameter(torch.zeros(f, f // groups, 3, 3))
        self.bn2 = bn(f)
        self.conv3 = nn.Conv2d(f, f, 1, bias=False)
        self.bn3 = bn(f)
        if dim_match:
            self.sc = None
        else:
            self.sc = nn.Conv2d(cin, f, 1, stride=stride, bias=False)
            self.sc_bn = bn(f)

    def forward(self, x):
        h = F.relu(self.bn1(self.c(self.conv1, x)))
        w2 = _Fp8.apply(self.conv2_weight) if self.fp8 else self.conv2_weight
        if self.deform:
            off = self.c(self.offset, h)
            a = _Fp8.apply(h) if self.fp8 else h
            h = ops.deformable_conv(
                a.permute(0, 2, 3, 1).contiguous(),
                off.permute(0, 2, 3, 1).contiguous(), w2, dilation=2,
                conv_groups=self.groups).permute(0, 3, 1, 2)
        else:
            a = _Fp8.apply(h) if self.fp8 else h
            h = F.conv2d(a, w2, None, self.stride, 1, 1, self.groups)
        h = F.relu(self.bn2(h))
        h = self.bn3(self.c(self.conv3, h))
        sc = x if self.sc is None else self.sc_bn(self.c(self.sc, x))
        return F.relu(h + sc)


class ResNeXtTrunk(_Trunk):
    def __init__(self, units=(3, 4, 23, 3)):
        super().__init__()
        filters = (64, 256, 512, 1024, 2048)
        self.units = tuple(units)
        self.out_channels = filters[3] + filters[4]
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = FrozenBN(64)
        cin = 64
        for i in range(4):
            for j in range(self.units[i]):
                self.add_module(f"stage{i + 1}_unit{j + 1}", ResNeXtUnit(
                    cin, filters[i + 1],
                    stride=2 if j == 0 and i in (1, 2) else 1,
                    dim_match=j > 0, fix_bn=i == 0, deform=i == 3))
                cin = filters[i + 1]

    def forward(self, x):
        h = F.relu(self.bn0(self.c(self.conv0, x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        c4 = None
        for i in range(4):
            if i == 3:
                c4 = h
            for j in range(self.units[i]):
                h = getattr(self, f"stage{i + 1}_unit{j + 1}")(h)
        return torch.cat([c4, h], dim=1)


class RPNHead(nn.Module):
    def __init__(self, cin, A):
        super().__init__()
        self.A = A
        self.rpn_conv_3x3 = nn.Conv2d(cin, 512, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(512, 2 * A, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * A, 1)

    def forward(self, feat):
        h = torch.relu(conv(self.rpn_conv_3x3, feat))
        cls = conv(self.rpn_cls_score, h)
        b, _, fh, fw = cls.shape
        cls = cls.permute(0, 2, 3, 1).reshape(b, fh, fw, 2, self.A)
        return cls, conv(self.rpn_bbox_pred, h)


class RCNNHead(nn.Module):
    def __init__(self, num_classes, fc_dim=1024, P=7, C=256):
        super().__init__()
        self.P = P
        self.offset = nn.Linear(P * P * C, 2 * P * P)
        self.fc_new_1 = nn.Linear(P * P * C, fc_dim)
        self.fc_new_2 = nn.Linear(fc_dim, fc_dim)
        self.cls_score = nn.Linear(fc_dim, num_classes)
        self.bbox_pred = nn.Linear(fc_dim, 4)

    def forward(self, roi_feat_map, rois, spatial_scale):
        B = roi_feat_map.shape[0]
        pooled = ops.offset_pool(
            roi_feat_map, rois, self.offset.weight, self.offset.bias,
            rois_per_image=rois.shape[0] // B, pooled_size=self.P,
            spatial_scale=spatial_scale)
        h = torch.relu(self.fc_new_1(pooled))
        h = torch.relu(self.fc_new_2(h))
        return self.cls_score(h), self.bbox_pred(h)


def smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _ce(logits, labels):
    """Valid-normalized softmax CE, labels -1 ignored."""
    labels = labels.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = labels >= 0
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


class Detector(nn.Module):
    """The box detector; ``cfg`` is the benchmark configuration's ``yml``
    dict (network, TRAIN and TEST keys of SNIPER's yml)."""

    def __init__(self, cfg, trunk="resnet", units=(3, 4, 23, 3)):
        super().__init__()
        net, tr, te = cfg["network"], cfg["TRAIN"], cfg["TEST"]
        self.num_classes = cfg["dataset"]["NUM_CLASSES"]
        self.stride = net["RPN_FEAT_STRIDE"]
        self.ratios = tuple(net["ANCHOR_RATIOS"])
        self.scales = tuple(net["ANCHOR_SCALES"])
        A = net["NUM_ANCHORS"]
        self.pixel_means = tuple(float(v) for v in net["PIXEL_MEANS"])
        self.test_kw = dict(pre_nms=int(te["RPN_PRE_NMS_TOP_N"]),
                            thresh=float(te["RPN_NMS_THRESH"]),
                            min_size=float(te["RPN_MIN_SIZE"]))
        self.train_kw = dict(
            pre_nms=int(tr["RPN_PRE_NMS_TOP_N"]),
            post_nms=int(tr["RPN_POST_NMS_TOP_N"]),
            thresh=float(tr["RPN_NMS_THRESH"]),
            min_size=float(tr["RPN_MIN_SIZE"]),
            num_rois=int(tr["RPN_POST_NMS_TOP_N"]),
            fg_fraction=float(tr["FG_FRACTION"]),
            fg_thresh=float(tr["FG_THRESH"]),
            bg_thresh_hi=float(tr["BG_THRESH_HI"]),
            bg_thresh_lo=float(tr["BG_THRESH_LO"]),
            bbox_stds=tuple(tr["BBOX_STDS"]),
            bbox_means=tuple(tr["BBOX_MEANS"]))
        self.rpn_batch_size = int(tr["RPN_BATCH_SIZE"])
        self.trunk = (ResNetTrunk(units) if trunk == "resnet"
                      else ResNeXtTrunk(units))
        cin = self.trunk.out_channels
        self.rpn = RPNHead(cin, A)
        self.conv_new_1 = nn.Conv2d(cin, 256, 1)
        self.rcnn = RCNNHead(self.num_classes)

    def set_fp8(self, on: bool):
        for m in self.trunk.modules():
            if isinstance(m, _Trunk):
                m.fp8 = on

    def normalize(self, data, extent):
        """uint8 RGB [B,H,W,3] -> mean-subtracted fp32 over each image's
        extent (h, w), zeros beyond, NCHW."""
        means = torch.tensor(self.pixel_means[::-1], device=data.device)
        x = data.float() - means
        H, W = x.shape[1:3]
        hh = torch.arange(H, device=data.device, dtype=torch.float32)
        ww = torch.arange(W, device=data.device, dtype=torch.float32)
        mask = ((hh[None, :, None] < extent[:, None, None, 0])
                & (ww[None, None, :] < extent[:, None, None, 1]))
        return torch.where(mask[..., None], x, 0.0).permute(0, 3, 1, 2)

    def anchors(self, fh, fw, device):
        return torch.as_tensor(ops.make_anchors_ahw(
            fh, fw, self.stride, self.ratios, self.scales), device=device)

    def shared(self, x):
        feat = self.trunk(x)
        cls, bbox = self.rpn(feat)
        fg = torch.softmax(cls, dim=3)[..., 1, :].permute(0, 3, 1, 2)
        roi_map = torch.relu(conv(self.conv_new_1, feat)).permute(0, 2, 3, 1)
        return feat, cls, bbox, fg.contiguous(), roi_map.contiguous()

    def head(self, roi_map, rois):
        """cls_prob [B,N,C] and bbox_pred [B,N,4] (std-denormalized) of
        rois [B,N,5]."""
        b, n = rois.shape[:2]
        cls, bbox = self.rcnn(roi_map, rois.reshape(-1, 5), 1.0 / self.stride)
        stds = torch.tensor(self.train_kw["bbox_stds"], device=rois.device)
        means = torch.tensor(self.train_kw["bbox_means"], device=rois.device)
        return (torch.softmax(cls, -1).reshape(b, n, -1),
                (bbox * stds + means).reshape(b, n, 4))

    def infer(self, data, im_info, post_nms):
        """Inference on uint8 canvases: rois [B,N,5], roi_scores,
        roi_valid, and the roi map for ``head``."""
        feat, _, bbox, fg, roi_map = self.shared(
            self.normalize(data, im_info))
        rois, scores, valid = ops.proposals(
            fg, bbox, im_info, self.anchors(feat.shape[2], feat.shape[3],
                                            feat.device),
            post_nms=post_nms, **self.test_kw)
        return dict(rois=ops.with_batch_idx(rois), roi_scores=scores,
                    roi_valid=valid, roi_map=roi_map)

    def sample(self, batch, priorities):
        """The proposals' sampled rois of one batch by the sampler's
        priorities: (rois [B,R,5], labels [B,R], targets, weights), and the
        trunk's outputs (feat, RPN logits and deltas, roi map)."""
        x = self.normalize(batch["data"], batch["data_extent"])
        feat, cls, bbox, fg, roi_map = self.shared(x)
        sampled = ops.proposal_targets(
            fg.detach(), bbox.detach(), batch["im_info"], batch["gt_boxes"],
            batch["valid_ranges"],
            self.anchors(feat.shape[2], feat.shape[3], feat.device),
            priorities, **self.train_kw)
        return sampled, (feat, cls, bbox, roi_map)

    def loss(self, batch, priorities, given=None):
        """The training loss of one batch (the chip loader's keys) with the
        sampler's priorities: (loss, {term: value}, its own sample (rois,
        labels, targets, weights)). ``given`` replaces that sample in the
        loss, chip by chip, by one made elsewhere (the program's), which the
        loss then follows."""
        own, (feat, cls, bbox, roi_map) = self.sample(batch, priorities)
        rois, labels, tgt, w = own if given is None else (
            # a sample of fewer chips than the batch: the rest are its own
            torch.cat([g, o[g.shape[0]:]]) for g, o in zip(given, own))
        B = feat.shape[0]
        cls_score, bbox_pred = self.rcnn(roi_map, rois.reshape(-1, 5),
                                         1.0 / self.stride)
        b, h, wd, _, a = cls.shape
        logits = cls.permute(0, 4, 1, 2, 3).reshape(b, a * h * wd, 2)
        pids = batch["rpn_pids"].long()
        picked = torch.gather(logits, 1, pids.clamp_min(0)[..., None]
                              .expand(-1, -1, 2))
        lab = torch.where(pids >= 0, batch["rpn_label_vals"].float(), -1.0)
        l_rpn_cls = _ce(picked, lab)
        pred = bbox.reshape(b, a, 4, h, wd).permute(0, 1, 3, 4, 2).reshape(
            b, a * h * wd, 4)
        fpids = batch["fg_pids"].long()
        fp = torch.gather(pred, 1, fpids.clamp_min(0)[..., None]
                          .expand(-1, -1, 4))
        per = smooth_l1(fp - batch["fg_targets"].float()).sum(-1)
        l_rpn_bbox = (torch.where(fpids >= 0, per, 0.0).sum() * 3.0
                      / float(B * self.rpn_batch_size))
        l_rcnn_cls = _ce(cls_score.reshape(B, -1, self.num_classes), labels)
        l_rcnn_bbox = ((w * smooth_l1(bbox_pred.reshape(B, -1, 4) - tgt))
                       .sum() / (188.0 * B))
        terms = dict(rpn_cls_loss=l_rpn_cls, rpn_bbox_loss=l_rpn_bbox,
                     rcnn_cls_loss=l_rcnn_cls, rcnn_bbox_loss=l_rcnn_bbox)
        return sum(terms.values()), terms, own


def is_fixed(name, prefixes):
    """FIXED_PARAMS: a component of the dotted name starts with a prefix."""
    return any(part.startswith(tuple(prefixes)) for part in name.split("."))


def lr_at(cfg, step):
    """The yml's learning rate at 0-based ``step``: linear warm-up from
    warmup_lr over warmup_step steps, then lr (the lr_step decays lie
    beyond any benchmark run), fp32 as the recipe computes it."""
    tr = cfg["TRAIN"]
    f32 = np.float32
    if not tr["warmup"]:
        return float(f32(tr["lr"]))
    frac = np.clip(f32(step) / f32(max(tr["warmup_step"], 1)), f32(0), f32(1))
    lr = f32(tr["warmup_lr"]) + (f32(tr["lr"]) - f32(tr["warmup_lr"])) * frac
    return float(lr) if step < tr["warmup_step"] else float(f32(tr["lr"]))


