"""The trunk's unit epilogue (ops/epilogue.py, csrc/unit_epilogue.cu).

On the CPU, in bf16: each form's plain version equals the module chain it
replaces, bit for bit; a unit (pre-activation and ResNeXt, identity and
projection shortcuts, C5's deformable units) and the R101 and X101 trunks'
(c4, c5) give the same bits through the fused path (``engages`` patched to
``applies``, so that the restructured code runs with the plain versions) as
through the unfused one; ``engages`` takes the fused path only on the card,
with autograd off, BatchNorms on running statistics that produce bf16 and a
channels_last input. On the card (``cuda``): the kernel against its plain
version, within one bf16 ulp.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sniper_tpu_torch.models.norm import FrozenBatchNorm, TrainBatchNorm
from sniper_tpu_torch.models.resnet import PreActBottleneck, ResNetTrunk
from sniper_tpu_torch.models.resnext import ResNeXtTrunk, ResNeXtUnit
from sniper_tpu_torch.ops import epilogue
from torch_port import cuda_or_skip

BF16 = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return x.to(BF16).contiguous(memory_format=torch.channels_last)


def _randomize(module, rng):
    """Running statistics and affine parameters away from the identity, so
    that every BatchNorm changes its input; convs scaled to keep the
    activations of order one."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(torch.from_numpy(
                    rng.randn(c).astype(np.float32) * 0.3))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.3, 2.0, c).astype(np.float32)))
                if m.weight is not None:
                    m.weight.copy_(torch.from_numpy(
                        rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    rng.randn(c).astype(np.float32) * 0.2))
    return module.eval()


def _bn(rng, c, cls=FrozenBatchNorm):
    return _randomize(cls(c, dtype=BF16), rng)


def _fused(monkeypatch):
    """Run the trunk's fused path on the CPU: the predicate without its
    device test, the forms through their plain versions."""
    monkeypatch.setattr(epilogue, "engages", epilogue.applies)


def _unfused(monkeypatch):
    monkeypatch.setattr(epilogue, "engages", lambda *a: False)


# --- the forms' plain versions against the chains they replace -----------

@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bn_relu_plain_is_the_chain(rng, dtype):
    a = _bf16(rng, 2, 16, 5, 7).to(dtype)
    bn = _bn(rng, 16)
    want = F.relu(bn(a.to(BF16)), inplace=True)
    assert torch.equal(epilogue.bn_relu(a, bn), want)


@pytest.mark.parametrize("keep_sum", [True, False])
def test_sum_bn_relu_plain_is_the_chain(rng, keep_sum):
    h, sc = _bf16(rng, 2, 16, 5, 7), _bf16(rng, 2, 16, 5, 7)
    bn = _bn(rng, 16)
    x, act = epilogue.sum_bn_relu(h, sc, bn, keep_sum)
    want = h + sc
    assert torch.equal(act, F.relu(bn(want), inplace=True))
    assert (x is None) if not keep_sum else torch.equal(x, want)


@pytest.mark.parametrize("projection", [False, True])
def test_bn_add_relu_plain_is_the_chain(rng, projection):
    h, s = _bf16(rng, 2, 16, 5, 7), _bf16(rng, 2, 16, 5, 7)
    bn = _bn(rng, 16)
    sc_bn = _bn(rng, 16) if projection else None
    want = F.relu(bn(h) + (sc_bn(s) if projection else s.float()))
    got = epilogue.bn_add_relu(h, bn, s, sc_bn)
    assert got.dtype == BF16
    assert torch.equal(got, want.to(BF16))


# --- units and trunks: the fused path against the unfused one ------------

UNITS = {
    "preact_identity": lambda: PreActBottleneck(64, 64),
    "preact_projection": lambda: PreActBottleneck(32, 64, stride=2,
                                                  dim_match=False),
    "preact_frozen": lambda: PreActBottleneck(64, 64, fix_bn=True),
    "preact_deform": lambda: PreActBottleneck(64, 64, dilation=2,
                                              deform=True),
    "preact_deform_projection": lambda: PreActBottleneck(
        32, 64, dim_match=False, dilation=2, deform=True),
    "resnext_identity": lambda: ResNeXtUnit(64, 64, num_groups=8),
    "resnext_projection": lambda: ResNeXtUnit(32, 64, stride=2,
                                              dim_match=False, num_groups=8),
    "resnext_frozen": lambda: ResNeXtUnit(32, 64, dim_match=False,
                                          fix_bn=True, num_groups=8),
    "resnext_deform": lambda: ResNeXtUnit(64, 64, num_groups=8,
                                          deform=True),
    "resnext_deform_projection": lambda: ResNeXtUnit(
        32, 64, dim_match=False, num_groups=8, deform=True),
}


def _unit_out(unit, x, pair):
    with torch.inference_mode():
        if isinstance(unit, PreActBottleneck) and pair:
            parts = list(x)
            h, sc = unit.pair(parts)
            assert parts == []  # the unit frees the pair it summed
            return torch.cat([h, sc], 1)
        return unit(x)


@pytest.mark.parametrize("name,pair", [
    (name, pair) for name in sorted(UNITS)
    for pair in ((False, True) if name.startswith("preact") else (False,))])
def test_unit_fused_path_is_bit_for_bit(rng, monkeypatch, name, pair):
    """A unit through the epilogue's forms equals the unfused unit; a
    pre-activation unit also from the previous unit's [h, sc], and as its
    own [h, sc]."""
    torch.manual_seed(0)
    unit = _randomize(UNITS[name](), rng)
    cin = unit.conv1.in_channels
    x = _bf16(rng, 2, cin, 9, 11)
    if pair:
        x = (x, _bf16(rng, 2, cin, 9, 11))
    _unfused(monkeypatch)
    want = _unit_out(unit, x, pair)
    _fused(monkeypatch)
    got = _unit_out(unit, x, pair)
    assert torch.equal(got, want)


TRUNKS = {
    "r101": lambda: ResNetTrunk(units=(1, 2, 2, 2),
                                filters=(16, 32, 64, 128, 256)),
    "x101": lambda: ResNeXtTrunk(units=(1, 2, 2, 2),
                                 filters=(16, 32, 64, 128, 256),
                                 num_groups=8),
}


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_trunk_fused_path_is_bit_for_bit(rng, monkeypatch, name):
    """The trunk's (c4, c5) with every unit epilogue through the fused code
    (R101's units handing [h, sc] to the next) equal the unfused trunk's."""
    torch.manual_seed(0)
    trunk = _randomize(TRUNKS[name](), rng)
    x = torch.from_numpy(rng.randn(2, 3, 64, 80).astype(np.float32) * 50)
    x = x.contiguous(memory_format=torch.channels_last)

    def run():
        with torch.inference_mode():
            return trunk(x)

    _unfused(monkeypatch)
    want = run()
    _fused(monkeypatch)
    got = run()
    for g, w in zip(got, want):
        assert g.dtype == BF16
        assert torch.equal(g, w)
    assert float(want[1].float().abs().max()) > 0


# --- where the fused path engages ----------------------------------------

def _case(case, rng):
    """(x, bns, grad mode) of an engagement case and its expected answer
    from ``applies``."""
    x = _bf16(rng, 2, 16, 4, 4)
    frozen, train = _bn(rng, 16), _bn(rng, 16, TrainBatchNorm)
    if case == "eval":
        return x, (frozen, train), False, True
    if case == "stem_fp32":
        return x.float(), (frozen,), False, True
    if case == "frozen_in_train_mode":
        return x, (frozen.train(),), False, True
    if case == "grad_enabled":
        return x, (frozen, train), True, False
    if case == "training_batchnorm":
        return x, (frozen, train.train()), False, False
    if case == "not_channels_last":
        return x.contiguous(), (frozen,), False, False
    if case == "fp32_batchnorm":
        return x, (_randomize(FrozenBatchNorm(16), rng),), False, False
    raise ValueError(case)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("case", [
    "eval", "stem_fp32", "frozen_in_train_mode", "grad_enabled",
    "training_batchnorm", "not_channels_last", "fp32_batchnorm"])
def test_engagement(rng, case, mode):
    x, bns, grad, want = _case(case, rng)
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx, torch.set_grad_enabled(grad):
        assert epilogue.applies(x, *bns) == want
        # never on the CPU: the CPU path keeps its modules
        assert not epilogue.engages(x, *bns)


def test_training_trunk_takes_the_unfused_path(rng, monkeypatch):
    """A training step's trunk: with autograd recording, nothing engages
    but the frozen stem and stage 1, which R101 runs without autograd."""
    calls = []
    real = epilogue.applies

    def spy(x, *bns):
        calls.append(real(x, *bns))
        return calls[-1]

    monkeypatch.setattr(epilogue, "engages", spy)
    trunk = _randomize(TRUNKS["r101"](), rng).train()
    for m in trunk._early():  # FIXED_PARAMS: the stem and stage 1
        m.requires_grad_(False)
    x = torch.from_numpy(rng.randn(2, 3, 64, 80).astype(np.float32))
    c4, c5 = trunk(x.contiguous(memory_format=torch.channels_last))
    assert c5.requires_grad
    # the stem and stage 1's unit engage; the 6 units of stages 2-4 do not
    assert calls == [True, True] + [False] * 6


# --- on the card ---------------------------------------------------------

def _ulps(got, want):
    """Largest gap in bf16 ulps of want's magnitude (0 where both agree)."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(w.abs().clamp_min(2.0 ** -126))[1] - 8)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 12, 16), (8, 2048, 1, 2),
                                   (3, 64, 7, 5)])
def test_kernel_matches_plain_on_the_card(rng, shape):
    """Each form through the kernel against its plain version on the card:
    within one bf16 ulp (F.batch_norm's own fp32 formula may round the last
    bit another way), at a FocusChip tier's 1x2 map too."""
    dev = cuda_or_skip()
    C = shape[1]
    bn, sc_bn = (_bn(rng, C).to(dev) for _ in range(2))
    h, s = (_bf16(rng, *shape).to(dev) for _ in range(2))
    with torch.inference_mode():
        cases = {
            "bn_relu": (epilogue.bn_relu(h, bn),
                        epilogue.bn_relu_plain(h, bn)),
            "bn_relu_fp32": (epilogue.bn_relu(h.float(), bn),
                             epilogue.bn_relu_plain(h.float(), bn)),
            "bn_add_relu": (epilogue.bn_add_relu(h, bn, s),
                            epilogue.bn_add_relu_plain(h, bn, s)),
            "bn_add_relu_projection": (
                epilogue.bn_add_relu(h, bn, s, sc_bn),
                epilogue.bn_add_relu_plain(h, bn, s, sc_bn)),
        }
        x, act = epilogue.sum_bn_relu(h, s, bn, True)
        px, pact = epilogue.sum_bn_relu_plain(h, s, bn, True)
        cases["sum"] = (x, px)
        cases["sum_bn_relu"] = (act, pact)
        cases["sum_bn_relu_no_sum"] = (
            epilogue.sum_bn_relu(h, s, bn, False)[1], pact)
    torch.cuda.synchronize()
    for name, (got, want) in cases.items():
        assert got.is_contiguous(memory_format=torch.channels_last), name
        assert _ulps(got, want) <= 1, name


@pytest.mark.cuda
def test_trunk_engagement_on_the_card(rng):
    """A tiny R101 trunk on the card: at inference every unit epilogue runs
    fused (1 + 3 a unit) and bit for bit the unfused trunk; in training
    with autograd recording none does, and each counts as unfused."""
    from sniper_tpu_torch.ops import cuda

    dev = cuda_or_skip()
    trunk = _randomize(TRUNKS["r101"](), rng).to(dev)
    x = torch.from_numpy(rng.randn(2, 3, 64, 80).astype(np.float32) * 50)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    n_units = sum(trunk.units)

    def counts():
        return cuda.UNIT_EPILOGUE.launches, cuda.UNFUSED_EPILOGUES

    cuda.UNIT_EPILOGUE.launches = cuda.UNFUSED_EPILOGUES = 0
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, deterministic=True):
        got = trunk(x)
        fused = counts()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(epilogue, "engages", lambda *a: False)
            want = trunk(x)
    assert fused == (1 + 3 * n_units, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cuda.UNIT_EPILOGUE.launches = cuda.UNFUSED_EPILOGUES = 0
    trunk.train()
    trunk(x)
    assert counts() == (0, 1 + 3 * n_units)
