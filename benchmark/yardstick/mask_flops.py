"""The mask branch's floating-point work, counted from the reference mask
detector's shapes (benchmark/reference/mask.py), as yardstick/flops.py
counts the box detector's: multiply-adds x 2 of every product; the pools'
gathers, the ReLUs, the plane pick and the softmax count 0.

Per roi: the offset FC (2 * 50176 * 392), four 3x3 convs at 14x14 (2 * 196
* 256 * 256 * 9 each), the 2x2 stride-2 transposed conv (each of the
28x28 outputs takes one tap of each input channel: 2 * 784 * 256 * 256)
and the 1x1 output conv (2 * 784 * 256 * 160): about 1.13 GFLOP.
"""

from __future__ import annotations


def mask_flops(model, rois: int) -> int:
    """Forward FLOPs of the mask branch of ``model`` (a reference
    MaskDetector, on any device, the meta device included) over ``rois``
    rois."""
    fc = model.mask_offset
    flops = 2 * rois * fc.in_features * fc.out_features
    side = int(round((fc.out_features // 2) ** 0.5))  # the pool's 14
    head = model.mask
    for i in range(4):
        m = getattr(head, f"mask_conv_3x3_{i + 1}")
        kh, kw = m.kernel_size
        flops += 2 * rois * side * side * m.out_channels * m.in_channels \
            * kh * kw
    d = head.mask_deconv
    side *= d.stride[0]
    taps = d.kernel_size[0] * d.kernel_size[1] // (d.stride[0] * d.stride[1])
    flops += 2 * rois * side * side * d.out_channels * d.in_channels * taps
    m = head.mask_out
    flops += 2 * rois * side * side * m.out_channels * m.in_channels
    return flops
