"""The plain operations of the reference detector, in fp32 PyTorch.

A frozen copy of the plain (non-kernel) paths of the port's ops, written
to import nothing of the port: anchors, box geometry, greedy NMS, the
proposal and proposal-target ops, the DCNv1 im2col with its hand-written
backward, and the two-pass deformable PSROI pool with its hand-written
backward. The backwards are written out as the JAX package's are (the
conventions at the kinks: ``abs'(0) = +1``, clips and maxima split ties in
half, the DCN positional gradient zero on the clamped border), so that the
reference's gradients follow the same function as the program's, not
autograd's conventions at the kinks.

All image arrays are NHWC. Everything computes in fp32, whatever device
the tensors are on.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e10
# the offset FC's gradient scale inside the pool's backward (the
# reference's lr_mult of 0.01 on that layer)
OFFSET_GRAD_MULT = 0.01

# ---------------------------------------------------------------------------
# anchors and boxes
# ---------------------------------------------------------------------------


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """py-faster-rcnn's anchors [len(ratios)*len(scales), 4], ratio-major,
    xyxy in the +1 convention, widths rounded."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    x_ctr = base[0] + 0.5 * (w - 1)
    y_ctr = base[1] + 0.5 * (h - 1)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    ws = (ws[:, None] * scales[None, :]).reshape(-1)[:, None]
    hs = (hs[:, None] * scales[None, :]).reshape(-1)[:, None]
    return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])


def shift_anchors(base_anchors, feat_height, feat_width, feat_stride):
    """The dense grid [H*W*A, 4], position-major."""
    a = np.asarray(base_anchors, dtype=np.float64)
    sx, sy = np.meshgrid(np.arange(feat_width) * feat_stride,
                         np.arange(feat_height) * feat_stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (a[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


def make_anchors_ahw(feat_h, feat_w, feat_stride, ratios, scales):
    """The anchor grid [A*H*W, 4] fp32 in (A, H, W) order, the order of the
    RPN's conv channels."""
    base = generate_anchors(feat_stride, list(ratios), list(scales))
    a_khw = shift_anchors(base, feat_h, feat_w, feat_stride)
    A, k = base.shape[0], feat_h * feat_w
    return (a_khw.reshape(k, A, 4).transpose(1, 0, 2).reshape(A * k, 4)
            .astype(np.float32))


def _stack(parts, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (
        boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes, query_boxes):
    """IoU [N, K] of NumPy boxes [N,4] and [K,4], +1 widths."""
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0]) + 1
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1]) + 1
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    union = box_area(boxes)[:, None] + box_area(query_boxes)[None, :] - inter
    return np.where(inter > 0.0, inter / union, 0.0)


def bbox_transform(ex_rois, gt_rois):
    """Encode gt boxes against example rois -> deltas [..., 4]."""
    log = torch.log if isinstance(ex_rois, torch.Tensor) else np.log
    ew = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    eh = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex = ex_rois[..., 0] + 0.5 * (ew - 1.0)
    ey = ex_rois[..., 1] + 0.5 * (eh - 1.0)
    gw = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gh = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gx = gt_rois[..., 0] + 0.5 * (gw - 1.0)
    gy = gt_rois[..., 1] + 0.5 * (gh - 1.0)
    return _stack([(gx - ex) / (ew + 1e-7), (gy - ey) / (eh + 1e-7),
                   log(gw / (ew + 1e-7)), log(gh / (eh + 1e-7))], ex_rois)


def clip_boxes(boxes, im_shape):
    """Clip [..., 4] xyxy boxes to [0, W-1] x [0, H-1]; H and W may be
    tensors that broadcast against boxes[..., 0]."""
    h, w = im_shape[0], im_shape[1]
    if isinstance(boxes, torch.Tensor):
        def clip(v, hi):
            return torch.minimum(v.clamp_min(0.0), torch.as_tensor(
                hi, dtype=v.dtype, device=v.device))
    else:
        def clip(v, hi):
            return np.clip(v, np.zeros_like(v), hi)
    return _stack([clip(boxes[..., 0], w - 1.0), clip(boxes[..., 1], h - 1.0),
                   clip(boxes[..., 2], w - 1.0), clip(boxes[..., 3], h - 1.0)],
                  boxes)


def bbox_pred(boxes, deltas):
    """Decode deltas [..., 4] on boxes [..., 4]."""
    exp = torch.exp if isinstance(deltas, torch.Tensor) else np.exp
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[..., 1] + 0.5 * (heights - 1.0)
    px = deltas[..., 0] * widths + ctr_x
    py = deltas[..., 1] * heights + ctr_y
    pw = exp(deltas[..., 2]) * widths
    ph = exp(deltas[..., 3]) * heights
    return _stack([px - 0.5 * (pw - 1.0), py - 0.5 * (ph - 1.0),
                   px + 0.5 * (pw - 1.0), py + 0.5 * (ph - 1.0)], deltas)


# ---------------------------------------------------------------------------
# NMS and proposals
# ---------------------------------------------------------------------------


def nms_plain(boxes, scores, max_out, thresh):
    """Greedy NMS batched over images: the highest live score is kept,
    the first index among ties, and every box with +1-width IoU >= thresh
    against it is retired; only scores above NEG_INF/2 are selectable.
    Returns keep [B, max_out] int64 (-1 padded) and valid [B, max_out]."""
    B, N = scores.shape
    boxes = boxes.float()
    areas = box_area(boxes)
    live = scores.float().clone()
    rows = torch.arange(B, device=boxes.device)
    keep = torch.full((B, max_out), -1, dtype=torch.int64,
                      device=boxes.device)
    valid = torch.zeros((B, max_out), dtype=torch.bool, device=boxes.device)
    for k in range(max_out):
        i = torch.argmax(live, dim=1)
        ok = live[rows, i] > NEG_INF / 2
        bi = boxes[rows, i]
        xx1 = torch.maximum(bi[:, None, 0], boxes[..., 0])
        yy1 = torch.maximum(bi[:, None, 1], boxes[..., 1])
        xx2 = torch.minimum(bi[:, None, 2], boxes[..., 2])
        yy2 = torch.minimum(bi[:, None, 3], boxes[..., 3])
        inter = ((xx2 - xx1 + 1).clamp_min(0.0)
                 * (yy2 - yy1 + 1).clamp_min(0.0))
        denom = areas[rows, i][:, None] + areas - inter
        ovr = torch.where(denom > 0, inter / denom, 0.0)
        live = torch.where(ok[:, None] & (ovr >= thresh), NEG_INF, live)
        live[rows, i] = NEG_INF
        keep[:, k] = torch.where(ok, i, -1)
        valid[:, k] = ok
    return keep, valid


def pair_iou_max(boxes, valid):
    """The largest +1-width IoU between two valid boxes of one image:
    boxes [B, N, 4], valid [B, N] -> [B]."""
    b = boxes.float()
    area = box_area(b)
    iw = (torch.minimum(b[:, :, None, 2], b[:, None, :, 2])
          - torch.maximum(b[:, :, None, 0], b[:, None, :, 0]) + 1)
    ih = (torch.minimum(b[:, :, None, 3], b[:, None, :, 3])
          - torch.maximum(b[:, :, None, 1], b[:, None, :, 1]) + 1)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    denom = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(denom > 0, inter / denom, 0.0)
    n = b.shape[1]
    pair = valid[:, :, None] & valid[:, None, :] & ~torch.eye(
        n, dtype=torch.bool, device=b.device)
    return torch.where(pair, iou, 0.0).flatten(1).amax(1)


def _top_k(values, k):
    """Descending, the lower index first among ties."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def proposals(fg_probs, deltas, im_info, anchors, *, pre_nms, post_nms,
              thresh, min_size):
    """fg_probs [B,A,H,W], deltas [B,4A,H,W] -> decode, clip, min-size
    filter, top ``pre_nms``, NMS: (boxes [B,post_nms,4], scores, valid),
    zeros where not valid."""
    B, A, H, W = fg_probs.shape
    scores = fg_probs.reshape(B, -1)
    d = deltas.reshape(B, A, 4, H, W).permute(0, 1, 3, 4, 2).reshape(B, -1, 4)
    props = bbox_pred(anchors[None], d)
    props = clip_boxes(props, (im_info[:, 0, None], im_info[:, 1, None]))
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    ms = min_size * im_info[:, 2:3]
    scores = torch.where((ws >= ms) & (hs >= ms), scores, NEG_INF)
    k = min(pre_nms, scores.shape[1])
    top_scores, top_idx = _top_k(scores, k)
    top_props = torch.gather(props, 1, top_idx[..., None].expand(B, k, 4))
    keep, valid = nms_plain(top_props, top_scores, post_nms, thresh)
    safe = keep.clamp_min(0)
    boxes = torch.where(
        valid[..., None],
        torch.gather(top_props, 1, safe[..., None].expand(B, post_nms, 4)),
        0.0)
    return boxes, torch.where(valid, torch.gather(top_scores, 1, safe),
                              0.0), valid


def with_batch_idx(boxes):
    B, n = boxes.shape[:2]
    idx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx[:, None, None].expand(B, n, 1), boxes], dim=-1)


def _gather_rows(x, idx):
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


@torch.no_grad()
def proposal_targets(fg_probs, deltas, im_info, gt_boxes, valid_ranges,
                     anchors, priorities, *, pre_nms, post_nms, thresh,
                     min_size, num_rois, fg_fraction, fg_thresh,
                     bg_thresh_hi, bg_thresh_lo, bbox_stds, bbox_means):
    """The training proposals with the GT boxes appended as candidates,
    labelled by IoU under the chips' valid ranges, then a fg/bg sample of
    ``num_rois`` per image by the priorities (fg_u, bg_u) [B, post_nms+G]
    (the higher first). Returns (rois [B,R,5], labels [B,R] (-1 ignore, 0
    bg, class), std-normalized targets [B,R,4], weights [B,R,4])."""
    props, _, prop_valid = proposals(
        fg_probs, deltas, im_info, anchors, pre_nms=pre_nms,
        post_nms=post_nms, thresh=thresh, min_size=min_size)
    fg_u, bg_u = priorities
    B, P = prop_valid.shape
    dev = props.device
    gt = gt_boxes[..., :4].float()
    gt_cls = gt_boxes[..., 4].float()
    gt_valid = gt_cls >= 0
    vr = valid_ranges.float()
    gt_area = torch.sqrt((gt[..., 2] - gt[..., 0]).clamp_min(0.0)
                         * (gt[..., 3] - gt[..., 1]).clamp_min(0.0))
    gt_in_range = (gt_area >= vr[:, 0:1]) & (gt_area <= vr[:, 1:2])
    cand = torch.cat([props, gt], dim=1)
    cand_is_gt = torch.cat(
        [torch.zeros(B, P, dtype=torch.bool, device=dev), gt_valid], dim=1)
    cand_live = torch.cat([prop_valid, gt_valid & gt_in_range], dim=1)
    c = cand[:, :, None, :]
    g = gt[:, None, :, :]
    iw = (torch.minimum(c[..., 2], g[..., 2])
          - torch.maximum(c[..., 0], g[..., 0]) + 1.0)
    ih = (torch.minimum(c[..., 3], g[..., 3])
          - torch.maximum(c[..., 1], g[..., 1]) + 1.0)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    iou = inter / (box_area(cand)[:, :, None] + box_area(gt)[:, None, :]
                   - inter)
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    max_iou, argmax_gt = iou.max(dim=2)
    matched_cls = torch.gather(gt_cls, 1, argmax_gt)
    matched_in_range = torch.gather(gt_in_range, 1, argmax_gt)
    is_fg = (max_iou >= fg_thresh) & cand_live & matched_in_range
    iou_invalid = torch.where((gt_valid & ~gt_in_range)[:, None, :], iou,
                              0.0).amax(dim=2)
    is_bg = ((max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)
             & cand_live & ~cand_is_gt & (iou_invalid <= 0.3))
    max_fg = int(np.round(num_rois * fg_fraction))
    fg_p, fg_idx = _top_k(torch.where(is_fg, fg_u, -1.0), max_fg)
    fg_take = fg_p > 0
    n_fg = fg_take.sum(dim=1, keepdim=True)
    bg_p, bg_idx = _top_k(torch.where(is_bg, bg_u, -1.0), num_rois)
    bg_rank = torch.arange(num_rois, device=dev)
    bg_take = (bg_p > 0) & (bg_rank[None] < (num_rois - n_fg))
    sel_idx = torch.cat([fg_idx, bg_idx], dim=1)
    sel_take = torch.cat([fg_take, bg_take], dim=1)
    sel_is_fg = torch.cat(
        [torch.ones(B, max_fg, dtype=torch.bool, device=dev),
         torch.zeros(B, num_rois, dtype=torch.bool, device=dev)], dim=1)
    order = torch.sort((~sel_take).to(torch.uint8), dim=1,
                       stable=True)[1][:, :num_rois]
    sel_idx = torch.gather(sel_idx, 1, order)
    sel_take = torch.gather(sel_take, 1, order)
    sel_is_fg = torch.gather(sel_is_fg, 1, order)
    rois = _gather_rows(cand, sel_idx)
    sel_gt = torch.gather(argmax_gt, 1, sel_idx)
    labels = torch.where(
        sel_take,
        torch.where(sel_is_fg, torch.gather(matched_cls, 1, sel_idx).long(),
                    0), -1)
    tgt = bbox_transform(rois, _gather_rows(gt, sel_gt))
    tgt = ((tgt - torch.tensor(bbox_means, dtype=torch.float32, device=dev))
           / torch.tensor(bbox_stds, dtype=torch.float32, device=dev))
    w = (sel_is_fg & sel_take).float()[..., None].expand(B, num_rois, 4)
    return with_batch_idx(rois), labels, tgt * w, w.contiguous()


# ---------------------------------------------------------------------------
# deformable convolution (DCNv1, the CLAMP border rule)
# ---------------------------------------------------------------------------


def _im2col_geometry(offsets, B, H, W, G, K, dilation):
    half = (K - 1) // 2 * dilation
    dev = offsets.device
    off = offsets.float().reshape(B, H, W, G, K * K, 2)
    taps = torch.arange(K * K, device=dev)
    ty = ((taps // K) * dilation - half).float()
    tx = ((taps % K) * dilation - half).float()
    base_y = torch.arange(H, device=dev, dtype=torch.float32)
    base_x = torch.arange(W, device=dev, dtype=torch.float32)
    sy = ((base_y[None, :, None, None, None] + ty) + off[..., 0]).clamp(
        0.0, H - 1.0)
    sx = ((base_x[None, None, :, None, None] + tx) + off[..., 1]).clamp(
        0.0, W - 1.0)
    y0 = torch.floor(sy).long().clamp_max(H - 2)
    x0 = torch.floor(sx).long().clamp_max(W - 2)
    return sy, sx, y0, x0, sy - y0.float(), sx - x0.float()


def deform_im2col(x, offsets, G, K, dilation):
    """x [B,H,W,C], offsets [B,H,W,G*K*K*2] ((dy, dx) per tap) -> the col
    [B,H,W,K*K,C] fp32: each tap's sample blended from its four corners."""
    B, H, W, C = x.shape
    cg = C // G
    _, _, y0, x0, ly, lx = _im2col_geometry(offsets, B, H, W, G, K, dilation)
    ly, lx = ly[..., None], lx[..., None]
    xg = x.float().reshape(B, H * W, G, cg)
    bi = torch.arange(B, device=x.device)[:, None, None, None, None]
    gi = torch.arange(G, device=x.device)[None, None, None, :, None]

    def corner(dy, dx):
        return xg[bi, (y0 + dy) * W + (x0 + dx), gi]

    top = corner(0, 0) * (1 - lx) + corner(0, 1) * lx
    bot = corner(1, 0) * (1 - lx) + corner(1, 1) * lx
    col = top * (1 - ly) + bot * ly  # [B,H,W,G,KK,cg]
    return col.permute(0, 1, 2, 4, 3, 5).reshape(B, H, W, K * K, C)


def deform_im2col_bwd(x, offsets, gcol, G, K, dilation):
    """The im2col's VJP: gcol [B,H,W,K*K,C] -> (gx [B,H,W,C], goff
    [B,H,W,G*K*K*2]); goff is zero where the clamped sample sits on the
    border."""
    B, H, W, C = x.shape
    KK = K * K
    cg = C // G
    sy, sx, y0, x0, ly, lx = _im2col_geometry(offsets, B, H, W, G, K,
                                              dilation)
    gq = gcol.float().reshape(B, H, W, KK, G, cg).permute(0, 1, 2, 4, 3, 5)
    ly, lx = ly[..., None], lx[..., None]
    xg = x.float().reshape(B, H * W, G, cg)
    bi = torch.arange(B, device=x.device)[:, None, None, None, None]
    gi = torch.arange(G, device=x.device)[None, None, None, :, None]
    gx = torch.zeros(B * H * W * G, cg, device=x.device)
    v = {}
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            pix = (y0 + dy) * W + (x0 + dx)
            v[dy, dx] = xg[bi, pix, gi]
            row = ((bi * (H * W) + pix) * G + gi).reshape(-1)
            gx.index_add_(0, row, ((wy * wx) * gq).reshape(-1, cg))
    dvy = (v[1, 0] - v[0, 0]) * (1 - lx) + (v[1, 1] - v[0, 1]) * lx
    dvx = (v[0, 1] - v[0, 0]) * (1 - ly) + (v[1, 1] - v[1, 0]) * ly
    my = ((sy > 0.0) & (sy < H - 1.0)).float()
    mx = ((sx > 0.0) & (sx < W - 1.0)).float()
    goff = torch.stack([(gq * dvy).sum(-1) * my, (gq * dvx).sum(-1) * mx],
                       dim=-1)
    return gx.reshape(B, H, W, C), goff.reshape(B, H, W, G * KK * 2)


class DeformIm2col(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, G, K, dilation):
        ctx.statics = (G, K, dilation)
        ctx.save_for_backward(x, offsets)
        return deform_im2col(x, offsets, G, K, dilation)

    @staticmethod
    def backward(ctx, gcol):
        x, offsets = ctx.saved_tensors
        gx, goff = deform_im2col_bwd(x, offsets, gcol, *ctx.statics)
        return gx, goff, None, None, None


def deformable_conv(x, offsets, weight, *, num_groups=4, dilation=2,
                    conv_groups=1):
    """DCNv1 3x3 conv, stride 1, 'same': x [B,H,W,Cin] fp32, offsets
    [B,H,W,G*9*2], OIHW weight [Cout, Cin/conv_groups, 3, 3] -> [B,H,W,Cout]
    fp32; with conv_groups > 1 the grouped product over the deformed
    taps."""
    B, H, W, C = x.shape
    col = DeformIm2col.apply(x, offsets, num_groups, 3, dilation)
    cout = weight.shape[0]
    CG = conv_groups
    cg_in = C // CG
    col = col.reshape(B * H * W, 9, CG, cg_in)
    w = weight.reshape(CG, cout // CG, cg_in, 3, 3).permute(0, 3, 4, 2, 1)
    w = w.reshape(CG, 9, cg_in, cout // CG).float()
    out = torch.einsum("ptgc,gtco->pgo", col, w)
    return out.reshape(B, H, W, cout)


# ---------------------------------------------------------------------------
# the two-pass deformable PSROI pool
# ---------------------------------------------------------------------------


def _roi_geom(rois, spatial_scale, T):
    x1 = torch.round(rois[..., 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[..., 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[..., 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[..., 4]) + 1.0) * spatial_scale - 0.5
    roi_w = (x2 - x1).clamp_min(0.1)
    roi_h = (y2 - y1).clamp_min(0.1)
    return x1, y1, roi_w, roi_h, roi_w / T, roi_h / T


def _resize_tents(start, step, n_out, n_in):
    o = torch.arange(n_out, device=start.device, dtype=torch.float32)
    pos = start[:, None] + o[None, :] * step[:, None]
    inb = ((pos > -0.5) & (pos < n_in - 0.5)).float()
    posc = pos.clamp(0.0, n_in - 1.0)
    cells = torch.arange(n_in, device=start.device, dtype=torch.float32)
    w = (1.0 - (posc[..., None] - cells).abs()).clamp_min(0.0)
    return w * inb[..., None], inb


def _avg_factors(P, S, M, E, device):
    b = np.arange(P * P)
    cell = np.arange(E)
    ay = ((cell[None, :] >= M + (b[:, None] // P) * S)
          & (cell[None, :] < M + (b[:, None] // P + 1) * S))
    ax = ((cell[None, :] >= M + (b[:, None] % P) * S)
          & (cell[None, :] < M + (b[:, None] % P + 1) * S))
    return (torch.as_tensor(ay, dtype=torch.float32, device=device),
            torch.as_tensor(ax, dtype=torch.float32, device=device))


def _tent_stack_pair(p0, S, E):
    """The S-tap tent stack at window starts p0 [R, PP] and its derivative
    in p0, each [R, PP, E] (abs'(0) = +1; a tent's edge carries half)."""
    cell = torch.arange(E, device=p0.device, dtype=torch.float32)
    w = torch.zeros(p0.shape + (E,), device=p0.device)
    dw = torch.zeros_like(w)
    for k in range(S):
        d = p0[..., None] + k - cell
        ad = d.abs()
        w = w + (1.0 - ad).clamp_min(0.0)
        gate = (ad < 1.0).float() + 0.5 * (ad == 1.0).float()
        dw = dw - torch.where(d >= 0, 1.0, -1.0) * gate
    return w, dw


def _image_chunks(R, rpi, size=64):
    for r0 in range(0, R, size):
        r1 = min(R, r0 + size)
        for b in range(r0 // rpi, (r1 - 1) // rpi + 1):
            yield b, max(r0, b * rpi), min(r1, (b + 1) * rpi)


def _factors(geom, pypx, P, S, M, H, W):
    E = P * S + 2 * M
    R = geom.shape[0]
    wy, vy = _resize_tents(geom[:, 0], geom[:, 2], E, H)
    wx, vx = _resize_tents(geom[:, 1], geom[:, 3], E, W)
    if pypx is None:
        ay, ax = _avg_factors(P, S, M, E, geom.device)
        fy, fx = ay.expand(R, -1, -1), ax.expand(R, -1, -1)
        dfy = dfx = None
    else:
        fy, dfy = _tent_stack_pair(pypx[:, 0], S, E)
        fx, dfx = _tent_stack_pair(pypx[:, 1], S, E)
    return wy, vy, wx, vx, fy, fx, dfy, dfx


def pool_pass(feat, geom, pypx, *, rois_per_image, P, S, M):
    """One pool pass: pass A (pypx None) averages each bin's S x S
    undeformed samples, pass B each bin's samples shifted to its window
    start. feat [B,H,W,C], geom [R,4] = (ys, xs, sub_h, sub_w). Returns
    [R, P*P, C] fp32."""
    B, H, W, C = feat.shape
    R = geom.shape[0]
    wy, vy, wx, vx, fy, fx, _, _ = _factors(geom, pypx, P, S, M, H, W)
    cy = fy @ wy
    cx = fx @ wx
    n = (fy * vy[:, None, :]).sum(-1) * (fx * vx[:, None, :]).sum(-1)
    numer = torch.empty((R, P * P, C), device=feat.device)
    for b, lo, hi in _image_chunks(R, rois_per_image):
        featt = feat[b].float().permute(1, 0, 2).reshape(W, H * C)
        tmp = (cx[lo:hi] @ featt).reshape(hi - lo, P * P, H, C)
        numer[lo:hi] = (tmp * cy[lo:hi, :, :, None]).sum(2)
    n = n[..., None]
    return torch.where(n > 0, numer / n.clamp_min(1.0), 0.0)


def pool_pass_bwd(feat, geom, pypx, g, *, rois_per_image, P, S, M,
                  dfeat=None):
    """The transposed pool pass: adds the feature gradient to ``dfeat``;
    pass B also returns the window-start gradient [R, 2, P*P]."""
    B, H, W, C = feat.shape
    R = geom.shape[0]
    PP = P * P
    stencil = pypx is not None
    wy, vy, wx, vx, fy, fx, dfy_dp, dfx_dp = _factors(geom, pypx, P, S, M,
                                                      H, W)
    cy = fy @ wy
    cx = fx @ wx
    sy = (fy * vy[:, None, :]).sum(-1)
    sx = (fx * vx[:, None, :]).sum(-1)
    n = sy * sx
    pos = n > 0
    den = n.clamp_min(1.0)
    dnum = torch.where(pos[..., None], g / den[..., None], 0.0)
    if dfeat is None:
        dfeat = torch.zeros((B, H, W, C), device=feat.device)
    if stencil:
        numer = torch.empty((R, PP, C), device=feat.device)
        dcy = torch.empty((R, PP, H), device=feat.device)
        dcx = torch.empty((R, PP, W), device=feat.device)
    for b, lo, hi in _image_chunks(R, rois_per_image):
        featt = feat[b].float().permute(1, 0, 2).reshape(W, H * C)
        gg = (cy[lo:hi, :, :, None] * dnum[lo:hi, :, None, :]).reshape(
            -1, H * C)
        contrib = cx[lo:hi].reshape(-1, W).t() @ gg
        dfeat[b] += contrib.reshape(W, H, C).permute(1, 0, 2)
        if stencil:
            big = (cx[lo:hi] @ featt).reshape(hi - lo, PP, H, C)
            numer[lo:hi] = (big * cy[lo:hi, :, :, None]).sum(2)
            dcy[lo:hi] = (dnum[lo:hi, :, None, :] * big).sum(-1)
            dcx[lo:hi] = (gg @ featt.t()).reshape(hi - lo, PP, W)
    if not stencil:
        return dfeat, None
    tie = torch.where(n == 1.0, 0.5, 1.0)
    dn = torch.where(pos & (n >= 1.0),
                     -tie * (g * numer).sum(-1) / (den * den), 0.0)
    dfy = dcy @ wy.transpose(1, 2) + (dn * sx)[..., None] * vy[:, None, :]
    dfx = dcx @ wx.transpose(1, 2) + (dn * sy)[..., None] * vx[:, None, :]
    dpp = torch.stack([(dfy * dfy_dp).sum(-1), (dfx * dfx_dp).sum(-1)],
                      dim=1)
    return dfeat, dpp


def pool_geometry(rois, *, P, S, M, spatial_scale):
    x1, y1, roi_w, roi_h, sub_w, sub_h = _roi_geom(rois.float(),
                                                   spatial_scale, P * S)
    geom = torch.stack([y1 + (0.5 - M) * sub_h, x1 + (0.5 - M) * sub_w,
                        sub_h, sub_w], dim=-1)
    return geom.contiguous(), roi_h, roi_w, sub_h, sub_w


def _window_raw(off, roi_h, roi_w, sub_h, sub_w, *, P, S, M, trans_std):
    R = off.shape[0]
    p = torch.arange(P * P, device=off.device)
    base_y = (S * (p // P) + M).float()
    base_x = (S * (p % P) + M).float()
    raw_y = (base_y + off[:, :P * P] * trans_std * roi_h.reshape(R, 1)
             / sub_h.reshape(R, 1))
    raw_x = (base_x + off[:, P * P:] * trans_std * roi_w.reshape(R, 1)
             / sub_w.reshape(R, 1))
    return raw_y, raw_x


def _clip_mask(raw, hi):
    inside = (raw > 0.0) & (raw < hi)
    at_rail = (raw == 0.0) | (raw == hi)
    return inside.float() + 0.5 * at_rail.float()


class OffsetPool(torch.autograd.Function):
    """pass A -> offset FC -> clipped window starts -> pass B, with the
    hand-written backward (transposed pass B, the clip masks, the offset
    FC's transpose times OFFSET_GRAD_MULT, transposed pass A)."""

    @staticmethod
    def forward(ctx, feat, rois, off_w, off_b, statics):
        rpi, P, S, M, spatial_scale, trans_std = statics
        R = rois.shape[0]
        geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
            rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
        kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
        pass1 = pool_pass(feat, geom, None, **kw)
        off = pass1.reshape(R, -1) @ off_w.t() + off_b
        raw_y, raw_x = _window_raw(off, roi_h, roi_w, sub_h, sub_w, P=P,
                                   S=S, M=M, trans_std=trans_std)
        hi = float(P * S + 2 * M - S)
        pypx = torch.stack([raw_y.clamp(0.0, hi), raw_x.clamp(0.0, hi)], 1)
        pooled = pool_pass(feat, geom, pypx, **kw).reshape(R, -1)
        ctx.statics = statics
        ctx.save_for_backward(feat, rois, off_w, off_b, pass1)
        return pooled

    @staticmethod
    def backward(ctx, gpooled):
        feat, rois, off_w, off_b, pass1 = ctx.saved_tensors
        rpi, P, S, M, spatial_scale, trans_std = ctx.statics
        R, PP, C = pass1.shape
        geom, roi_h, roi_w, sub_h, sub_w = pool_geometry(
            rois, P=P, S=S, M=M, spatial_scale=spatial_scale)
        off = pass1.reshape(R, -1) @ off_w.t() + off_b
        raw_y, raw_x = _window_raw(off, roi_h, roi_w, sub_h, sub_w, P=P,
                                   S=S, M=M, trans_std=trans_std)
        hi = float(P * S + 2 * M - S)
        pypx = torch.stack([raw_y.clamp(0.0, hi), raw_x.clamp(0.0, hi)], 1)
        kw = dict(rois_per_image=rpi, P=P, S=S, M=M)
        g = gpooled.reshape(R, PP, C).float()
        dfeat, dpp = pool_pass_bwd(feat, geom, pypx, g, **kw)
        ddy = (dpp[:, 0] * _clip_mask(raw_y, hi)
               * (trans_std * roi_h.reshape(R, 1) / sub_h.reshape(R, 1)))
        ddx = (dpp[:, 1] * _clip_mask(raw_x, hi)
               * (trans_std * roi_w.reshape(R, 1) / sub_w.reshape(R, 1)))
        dfc = torch.cat([ddy, ddx], dim=1) * OFFSET_GRAD_MULT
        doff_w = dfc.t() @ pass1.reshape(R, PP * C)
        doff_b = dfc.sum(0)
        dpass1 = (dfc @ off_w).reshape(R, PP, C)
        dfeat, _ = pool_pass_bwd(feat, geom, None, dpass1, dfeat=dfeat, **kw)
        return dfeat, None, doff_w, doff_b, None


def offset_pool(feat, rois, off_w, off_b, *, rois_per_image, pooled_size=7,
                sample_per_part=4, spatial_scale=0.0625, trans_std=0.1,
                margin_bins=1):
    """The two-pass deformable ROI pool: feat [B,H,W,C], image-contiguous
    rois [B*rpi, 5] -> pooled [B*rpi, P*P*C] fp32, bins p-major."""
    S = sample_per_part
    statics = (rois_per_image, pooled_size, S, margin_bins * S,
               spatial_scale, trans_std)
    return OffsetPool.apply(feat.float().contiguous(), rois, off_w, off_b,
                            statics)
