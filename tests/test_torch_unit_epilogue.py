"""The trunk's unit epilogue (ops/epilogue.py, csrc/unit_epilogue.cu).

On the CPU, in bf16: each form, where the kernel does not engage, equals
the module chain it replaces, bit for bit, a training-mode BatchNorm's
gradients and running statistics included; a unit (pre-activation and
ResNeXt, identity and projection shortcuts, C5's deformable units) and the
R101 and X101 trunks' (c4, c5) give the same bits through the forms' kernel
branches (``engages`` patched to ``applies``, the launch standing in by
the plain versions: ``_cpu_launch``) as through their module chains;
``engages`` picks the kernel only on the card, with autograd off,
BatchNorms on running statistics that produce bf16 and a channels_last
input, and each form asks it once. On the card (``cuda``): the kernel
against its plain version, within one bf16 ulp.
"""

import copy

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


def _cpu_launch(form, a, b, out, out2, bn1, bn2=None):
    """The kernel's launch on the CPU: its outputs from the plain
    versions."""
    if form == epilogue.FORM_BN_RELU:
        out.copy_(epilogue.bn_relu_plain(a, bn1))
    elif form == epilogue.FORM_SUM_BN_RELU:
        x, act = epilogue.sum_bn_relu_plain(a, b, bn1, out is not None)
        if out is not None:
            out.copy_(x)
        out2.copy_(act)
    else:
        out.copy_(epilogue.bn_add_relu_plain(a, bn1, b, bn2))


def _fused(monkeypatch, engages=epilogue.applies):
    """Run the forms' kernel branches on the CPU: the predicate without
    its device test, the launch through the plain versions."""
    monkeypatch.setattr(epilogue, "engages", engages)
    monkeypatch.setattr(epilogue, "_launch", _cpu_launch)


def _unfused(monkeypatch):
    monkeypatch.setattr(epilogue, "engages", lambda *a: False)


# --- the forms' plain versions against the chains they replace -----------

def _chain_and_form(rng, train, inputs, chain, form, bns=1):
    """``chain`` and ``form`` on the same inputs, each with its own copy of
    ``bns`` BatchNorms (TrainBatchNorms in training mode with ``train``):
    both outputs bit for bit, and in training also the inputs' and the
    BatchNorms' gradients and their running statistics. Returns the
    form's outputs."""
    made = [_bn(rng, 16, TrainBatchNorm if train else FrozenBatchNorm)
            for _ in range(bns)]
    if train:
        made = [bn.train() for bn in made]
    runs = []
    for fn in (chain, form):
        ins = [t.detach().clone().requires_grad_(train) for t in inputs]
        mods = copy.deepcopy(made)
        with torch.set_grad_enabled(train):
            out = fn(*ins, *mods)
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if o is not None]
        if train:
            sum(o.float().square().sum() for o in outs).backward()
        runs.append((outs, ins, mods))
    (want, w_in, w_bn), (got, g_in, g_bn) = runs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if train:
        for g, w in zip(g_in, w_in):
            assert torch.equal(g.grad, w.grad)
        for g, w in zip(g_bn, w_bn):
            for name in ("weight", "bias"):
                assert torch.equal(getattr(g, name).grad,
                                   getattr(w, name).grad)
            for name in ("running_mean", "running_var"):
                assert torch.equal(getattr(g, name), getattr(w, name))
    return got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bn_relu_plain_is_the_chain(rng, dtype, train):
    a = _bf16(rng, 2, 16, 5, 7).to(dtype)
    _chain_and_form(rng, train, [a],
                    lambda a, bn: F.relu(bn(a.to(BF16)), inplace=True),
                    epilogue.bn_relu)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("keep_sum", [True, False])
def test_sum_bn_relu_plain_is_the_chain(rng, keep_sum, train):
    h, sc = _bf16(rng, 2, 16, 5, 7), _bf16(rng, 2, 16, 5, 7)

    def chain(h, sc, bn):
        x = h + sc
        return (x if keep_sum else None), F.relu(bn(x), inplace=True)

    got = _chain_and_form(
        rng, train, [h, sc], chain,
        lambda h, sc, bn: epilogue.sum_bn_relu(h, sc, bn, keep_sum))
    assert len(got) == (2 if keep_sum else 1)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("projection", [False, True])
def test_bn_add_relu_plain_is_the_chain(rng, projection, train):
    h, s = _bf16(rng, 2, 16, 5, 7), _bf16(rng, 2, 16, 5, 7)

    def chain(h, s, bn, sc_bn=None):
        sc = s.float() if sc_bn is None else sc_bn(s)
        return F.relu(bn(h) + sc).to(BF16)

    got = _chain_and_form(
        rng, train, [h, s], chain,
        lambda h, s, bn, sc_bn=None: epilogue.bn_add_relu(h, bn, s, sc_bn),
        bns=2 if projection else 1)
    assert got[0].dtype == BF16


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
    """A unit through the forms' kernel branches equals the unit through
    their module chains; a pre-activation unit also from the previous
    unit's [h, sc], and as its own [h, sc]."""
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
    """The trunk's (c4, c5) with every unit epilogue through the forms'
    kernel branches (R101's units handing [h, sc] to the next) equal the
    trunk's through their module chains."""
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
    """A training step's trunk: with autograd recording, no form engages
    but the frozen stem's and stage 1's, which R101 runs without
    autograd; each form asks once."""
    calls = []

    def spy(x, *bns):
        calls.append(epilogue.applies(x, *bns))
        return calls[-1]

    _fused(monkeypatch, spy)
    trunk = _randomize(TRUNKS["r101"](), rng).train()
    for m in trunk._early():  # FIXED_PARAMS: the stem and stage 1
        m.requires_grad_(False)
    x = torch.from_numpy(rng.randn(2, 3, 64, 80).astype(np.float32))
    c4, c5 = trunk(x.contiguous(memory_format=torch.channels_last))
    assert c5.requires_grad
    # the stem's form and stage 1's unit's three engage; the three forms of
    # each of the 6 units of stages 2-4 do not
    assert calls == [True] * 4 + [False] * 18


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
    as the kernel (1 + 3 a unit launches) and bit for bit the module
    chains; in training with autograd recording none does."""
    from sniper_tpu_torch.ops import cuda

    dev = cuda_or_skip()
    trunk = _randomize(TRUNKS["r101"](), rng).to(dev)
    x = torch.from_numpy(rng.randn(2, 3, 64, 80).astype(np.float32) * 50)
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    n_units = sum(trunk.units)

    cuda.UNIT_EPILOGUE.launches = 0
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, deterministic=True):
        got = trunk(x)
        fused = cuda.UNIT_EPILOGUE.launches
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(epilogue, "engages", lambda *a: False)
            want = trunk(x)
    assert fused == 1 + 3 * n_units
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cuda.UNIT_EPILOGUE.launches = 0
    trunk.train()
    trunk(x)
    assert cuda.UNIT_EPILOGUE.launches == 0
