"""NMS family for the port: NumPy host halves, plain torch greedy NMS, and
the batched CUDA kernel.

- ``nms_np``, ``soft_nms_np``, ``soft_nms_np_batched`` and ``NMSWrapper``
  are copies of sniper_tpu/ops/nms.py:28-281 (the Tester's soft-NMS
  aggregation needs them, and that module cannot be imported without jax).
- ``nms`` is greedy NMS over a batch of images with exactly nms_jax's
  contract (sniper_tpu/ops/nms.py:283-328): greedy by descending score,
  first index among ties, suppression at ``ovr >= thresh`` with +1 widths,
  ``ovr = 0`` where ``denom <= 0``, the chosen box always retired, only
  scores above NEG_INF/2 selectable; keep [B, max_out] int32 padded with -1,
  plus valid. On a CPU tensor it runs the plain version (nms_jax's
  argmax/suppress loop, batched); on a CUDA tensor it sorts and runs the
  kernel in csrc/nms.cu.
- ``nms_sorted`` is the same for input that is already sorted (the proposal
  op's top-k): the kernel runs on it as it is, with no sort.
"""

from __future__ import annotations

import numpy as np
import torch

from sniper_tpu_torch.ops import cuda
from sniper_tpu_torch.ops.boxes import box_area

NEG_INF = -1e10


def nms_np(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy hard NMS. dets [N,5] (xyxy, score) -> keep indices.

    Suppression uses ``ovr >= thresh`` like the reference CPU kernel.
    """
    if dets.shape[0] == 0:
        return []
    boxes = dets[:, :4].astype(np.float64)
    scores = dets[:, 4]
    areas = box_area(boxes)
    order = scores.argsort()[::-1]
    suppressed = np.zeros(dets.shape[0], dtype=bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        # degenerate/inverted boxes (x2 < x1-1) have +1-convention area
        # <= 0; the raw division then yields NaN, and ``NaN >= thresh``
        # is False — such a box would silently never be suppressed (and
        # never suppress). Guard the denominator: zero-area boxes can't
        # overlap anything, so their IoU is 0.
        denom = areas[i] + areas - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            ovr = np.where(denom > 0, inter / denom, 0.0)
        suppressed |= ovr >= thresh
    return keep


def soft_nms_np(
    boxes: np.ndarray,
    sigma: float = 0.5,
    Nt: float = 0.3,
    threshold: float = 0.001,
    method: int = 2,
    return_indices: bool = False,
):
    """Soft-NMS, bit-faithful to the reference Cython kernel.

    ``boxes`` is [N,5] float32 (xyxy, score); returns the surviving
    [M,5] rows in the reference's emission order (max-score selection
    sort with swap; decayed boxes below ``threshold`` replaced by the
    dynamic tail). Sequential by nature — float32 arithmetic throughout
    to match the Cython float locals. ``return_indices`` also returns
    each surviving row's ORIGINAL index (for carrying per-detection
    payloads like instance masks through the rescoring).

    The reference kernel is a scalar double loop; here the inner
    decay pass is VECTORIZED, which is exact: at each step i every
    remaining box is decayed exactly once (independently of the others
    and of the tail-swap order — swapped-in tail rows are re-examined
    by the reference's ``pos -= 1``), so computing all decays in one
    fp32 vector op gives bit-identical scores. The threshold drop's
    tail-swap dance is then replayed on the decayed rows to keep the
    exact array order (argmax tie-breaking depends on it).
    """
    b = np.array(boxes, dtype=np.float32, copy=True)
    if return_indices:
        # ride an index column through the row swaps (cols 0-4 drive the
        # algorithm; the extra column is inert)
        idx_col = np.arange(b.shape[0], dtype=np.float32)[:, None]
        b = np.concatenate([b, idx_col], axis=1)
    N = b.shape[0]
    sigma = np.float32(sigma)
    one = np.float32(1)
    i = 0
    while i < N:
        # select max-score box in b[i:N], swap into position i
        maxpos = i + int(np.argmax(b[i:N, 4]))
        b[[i, maxpos]] = b[[maxpos, i]]
        tx1, ty1, tx2, ty2 = b[i, 0], b[i, 1], b[i, 2], b[i, 3]
        tarea = np.float32((tx2 - tx1 + 1) * (ty2 - ty1 + 1))

        rest = b[i + 1 : N]
        if len(rest):
            area = (rest[:, 2] - rest[:, 0] + one) * (
                rest[:, 3] - rest[:, 1] + one
            )
            iw = np.minimum(tx2, rest[:, 2]) - np.maximum(tx1, rest[:, 0]) + one
            ih = np.minimum(ty2, rest[:, 3]) - np.maximum(ty1, rest[:, 1]) + one
            hit = (iw > 0) & (ih > 0)
            inter = iw * ih
            # guard degenerate boxes (area <= 0 under the +1 convention):
            # tarea + area - inter can be <= 0 only when both boxes are
            # degenerate, where a NaN score would otherwise poison the
            # argmax selection and never drop. IoU := 0 there.
            denom = tarea + area - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                ov = np.where(
                    hit & (denom > 0), inter / denom, np.float32(0)
                )
            if method == 1:  # linear
                weight = np.where(ov > Nt, one - ov, one)
            elif method == 2:  # gaussian
                weight = np.exp(-(ov * ov) / sigma)
            else:  # hard
                weight = np.where(ov > Nt, np.float32(0), one)
            rest[:, 4] = np.where(hit, weight * rest[:, 4], rest[:, 4])
            # replay the reference's drop/tail-swap order exactly: only
            # rows whose decay ran (hit) are eligible to drop
            drop = hit & (rest[:, 4] < threshold)
            if drop.any():
                eligible = np.zeros(len(b), bool)
                eligible[i + 1 : N] = drop
                pos = i + 1
                while pos < N:
                    if eligible[pos]:
                        b[pos] = b[N - 1]
                        eligible[pos] = eligible[N - 1]
                        N -= 1
                    else:
                        pos += 1
        i += 1
    if return_indices:
        return b[:N, :5], b[:N, 5].astype(np.int64)
    return b[:N]


def soft_nms_np_batched(
    dets_list,
    sigma: float = 0.5,
    Nt: float = 0.3,
    threshold: float = 0.001,
    method: int = 2,
    return_indices: bool = False,
):
    """Run soft-NMS on many INDEPENDENT problems (e.g. one per class) in
    a single padded greedy loop — bit-identical per problem to
    soft_nms_np, but the Python loop runs max(kept) iterations instead
    of sum(kept): one [C, Nmax] vector op per step covers every class.

    dets_list: sequence of [N_c, 5] float32 arrays. Returns a list of
    surviving [M_c, 5] arrays (plus a list of original-index arrays
    when return_indices).
    """
    C = len(dets_list)
    Ns = np.array([d.shape[0] for d in dets_list], dtype=int)
    Nmax = int(Ns.max()) if C else 0
    if Nmax == 0:
        outs = [np.zeros((0, 5), np.float32) for _ in range(C)]
        if return_indices:
            return outs, [np.zeros((0,), np.int64) for _ in range(C)]
        return outs
    K = 6 if return_indices else 5
    b = np.zeros((C, Nmax, K), np.float32)
    for c, d in enumerate(dets_list):
        n = d.shape[0]
        b[c, :n, :5] = d
        if return_indices:
            b[c, :n, 5] = np.arange(n, dtype=np.float32)

    N = Ns.copy()                 # live length per problem
    i = np.zeros(C, dtype=int)    # kept count per problem
    pos_idx = np.arange(Nmax)
    sigma = np.float32(sigma)
    one = np.float32(1)
    while True:
        act = i < N
        if not act.any():
            break
        rows = np.where(act)[0]
        ic = i[rows]
        # argmax over each row's [i_c, N_c) window (first-index ties,
        # like the scalar kernel's slice argmax)
        selmask = (pos_idx >= ic[:, None]) & (pos_idx < N[rows, None])
        S = np.where(selmask, b[rows, :, 4], -np.inf)
        maxpos = S.argmax(1)
        tmp = b[rows, ic].copy()
        b[rows, ic] = b[rows, maxpos]
        b[rows, maxpos] = tmp
        t = b[rows, ic]  # [R, K] the kept boxes this step
        tarea = (t[:, 2] - t[:, 0] + one) * (t[:, 3] - t[:, 1] + one)
        x1 = b[rows, :, 0]
        y1 = b[rows, :, 1]
        x2 = b[rows, :, 2]
        y2 = b[rows, :, 3]
        area = (x2 - x1 + one) * (y2 - y1 + one)
        iw = np.minimum(t[:, 2, None], x2) - np.maximum(t[:, 0, None], x1) + one
        ih = np.minimum(t[:, 3, None], y2) - np.maximum(t[:, 1, None], y1) + one
        postmask = (pos_idx[None] > ic[:, None]) & (pos_idx[None] < N[rows, None])
        hit = (iw > 0) & (ih > 0) & postmask
        inter = iw * ih
        # same degenerate-box guard as soft_nms_np: denom <= 0 => IoU 0
        denom = tarea[:, None] + area - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            ov = np.where(hit & (denom > 0), inter / denom, np.float32(0))
        if method == 1:
            weight = np.where(ov > Nt, one - ov, one)
        elif method == 2:
            weight = np.exp(-(ov * ov) / sigma)
        else:
            weight = np.where(ov > Nt, np.float32(0), one)
        scores = b[rows, :, 4]
        b[rows, :, 4] = np.where(hit, weight * scores, scores)
        # replay the reference drop/tail-swap order per row (rare path)
        drop = hit & (b[rows, :, 4] < threshold)
        for r, c in zip(np.where(drop.any(1))[0], rows[drop.any(1)]):
            elig = drop[r].copy()
            pos = int(elig.argmax())
            n_c = int(N[c])
            while pos < n_c:
                if elig[pos]:
                    b[c, pos] = b[c, n_c - 1]
                    elig[pos] = elig[n_c - 1]
                    n_c -= 1
                else:
                    pos += 1
            N[c] = n_c
        i[rows] = ic + 1
    outs = [b[c, : N[c], :5] for c in range(C)]
    if return_indices:
        return outs, [b[c, : N[c], 5].astype(np.int64) for c in range(C)]
    return outs


class NMSWrapper:
    """thresh>0 -> hard NMS; else gaussian soft-NMS with ``sigma``.

    Config (TEST.NMS, TEST.NMS_SIGMA) drives the same behavior as in
    sniper_tpu/ops/nms.py:NMSWrapper.
    """

    def __init__(self, thresh: float, sigma: float):
        assert thresh < 0 or sigma < 0, "set exactly one of thresh/sigma"
        self.thresh = thresh
        self.sigma = sigma

    def __call__(self, dets: np.ndarray, return_indices: bool = False):
        if self.thresh > 0:
            keep = nms_np(dets.astype(np.float32), self.thresh)
            if return_indices:
                return dets[keep], np.asarray(keep, np.int64)
            return dets[keep]
        return soft_nms_np(dets, sigma=self.sigma, method=2,
                           return_indices=return_indices)

    def batched(self, dets_list, return_indices: bool = False):
        """NMS over many independent det sets (e.g. the per-class sets
        of one image) — soft-NMS runs them in one padded greedy loop."""
        if self.thresh > 0:
            outs = [self(d, return_indices) for d in dets_list]
            if return_indices:
                return [o[0] for o in outs], [o[1] for o in outs]
            return outs
        return soft_nms_np_batched(dets_list, sigma=self.sigma, method=2,
                                   return_indices=return_indices)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
              thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """nms_jax's select-max/suppress loop, batched over images.

    boxes [B,N,4], scores [B,N] -> keep [B,max_out] int32 (-1 padded),
    valid [B,max_out] bool."""
    B, N = scores.shape
    boxes = boxes.float()
    areas = box_area(boxes)
    live = scores.float().clone()
    rows = torch.arange(B, device=boxes.device)
    keep = torch.full((B, max_out), -1, dtype=torch.int32,
                      device=boxes.device)
    valid = torch.zeros((B, max_out), dtype=torch.bool, device=boxes.device)
    thr = torch.tensor(thresh, dtype=torch.float32, device=boxes.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=boxes.device)
    for k in range(max_out):
        i = torch.argmax(live, dim=1)  # first index among ties
        ok = live[rows, i] > NEG_INF / 2
        bi = boxes[rows, i]  # [B,4]
        xx1 = torch.maximum(bi[:, None, 0], boxes[..., 0])
        yy1 = torch.maximum(bi[:, None, 1], boxes[..., 1])
        xx2 = torch.minimum(bi[:, None, 2], boxes[..., 2])
        yy2 = torch.minimum(bi[:, None, 3], boxes[..., 3])
        inter = ((xx2 - xx1 + 1).clamp_min(0.0)
                 * (yy2 - yy1 + 1).clamp_min(0.0))
        denom = areas[rows, i][:, None] + areas - inter
        ovr = torch.where(denom > 0, inter / denom, 0.0)
        live = torch.where(ok[:, None] & (ovr >= thr), neg, live)
        live[rows, i] = neg
        keep[:, k] = torch.where(ok, i.to(torch.int32), -1)
        valid[:, k] = ok
    return keep, valid


# the kernel's mask rows are padded to a multiple of 8 words of 64 boxes;
# its removed words take at most 12 KB of shared memory
MASK_ROW_WORDS = 8
MAX_KERNEL_BOXES = 12 * 1024 // 8 * 64


def scratch_words(b: int, n: int) -> int:
    """64-bit words of the kernel's scratch: the suppression mask (n rows
    of the padded word count per image), then the scan's state (the count,
    the done flag and the removed words per image)."""
    words = -(-n // 64)
    stride = -(-words // MASK_ROW_WORDS) * MASK_ROW_WORDS
    return b * n * stride + b * (stride + 2)


def _nms_kernel(boxes: torch.Tensor, scores: torch.Tensor,
                order: torch.Tensor | None, max_out: int,
                thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/nms.cu on sorted boxes and scores; keep indexes the
    sorted arrays, or ``order`` where it is given."""
    B, N = scores.shape
    cuda.require(boxes, "boxes", torch.float32, (B, N, 4))
    cuda.require(scores, "scores", torch.float32, (B, N))
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    if N < 1 or max_out < 1:
        raise ValueError(f"nms needs N >= 1 and max_out >= 1, got {N}, "
                         f"{max_out}")
    if N > MAX_KERNEL_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_KERNEL_BOXES} "
                         f"boxes, got {N}")
    if order is not None:
        cuda.require(order, "order", torch.int64, (B, N))
    scratch = torch.empty(scratch_words(B, N), dtype=torch.int64,
                          device=boxes.device)
    keep = torch.empty((B, max_out), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((B, max_out), dtype=torch.bool, device=boxes.device)
    lib = cuda.library()
    cuda.NMS.launches += 1
    cuda.check(lib.sniper_nms(
        boxes.data_ptr(), scores.data_ptr(),
        None if order is None else order.data_ptr(), B, N, max_out, thresh,
        NEG_INF / 2, scratch.data_ptr(), keep.data_ptr(), valid.data_ptr(),
        cuda.stream(boxes)), "nms")
    return keep, valid


def nms_sorted(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``nms`` for scores already sorted in descending order, ties in index
    order and entries at or below NEG_INF/2 last, as a stable descending
    sort leaves them; keep indexes the arrays given. The kernel does not
    check the order: on input that is not sorted it answers as if the scan
    order were the score order.

    boxes [B,N,4], scores [B,N] fp32. CPU tensors take the plain version;
    CUDA tensors the kernel, which raises on anything it does not take."""
    if boxes.is_cuda or scores.is_cuda:
        return _nms_kernel(boxes, scores, None, max_out, thresh)
    return nms_plain(boxes, scores, max_out, thresh)


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS with nms_jax's contract (module docstring).

    boxes [B,N,4], scores [B,N] fp32. CPU tensors take the plain version;
    CUDA tensors a stable descending sort (ties keep the lower index first,
    which is what nms_jax's argmax picks), then the kernel of
    ``nms_sorted``, which raises on anything it does not take."""
    if not (boxes.is_cuda or scores.is_cuda):
        return nms_plain(boxes, scores, max_out, thresh)
    B, N = scores.shape
    cuda.require(boxes, "boxes", torch.float32, (B, N, 4))
    sorted_scores, order = torch.sort(scores, dim=1, descending=True,
                                      stable=True)
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    return _nms_kernel(sorted_boxes, sorted_scores, order, max_out, thresh)
