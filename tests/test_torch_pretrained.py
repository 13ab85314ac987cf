"""The port's pretrained import (sniper_tpu_torch/train/pretrained.py)
against the JAX package's, on the CPU in fp32.

- The MXNet ``.params`` container both ways: the port writes and the JAX
  reader reads, and the reverse, bit for bit; garbage and truncated files
  raise.
- The full-mapping import: one seeded flat dict in MXNet's names and
  layouts, written for the tiny detector of tests/torch_port.py with the
  mask branch, goes through the JAX ``import_reference_params`` and then
  ``convert``; the port's import of the same file into the converted JAX
  init must give the same tensor on every key (``mask_deconv_weight``
  included: the JAX import stores MXNet's deconv kernel with no tap flip,
  and the port reproduces that result), and the same loaded, missing and
  unused names.
- A backbone-only file is a selective re-init; FIXED_PARAMS over unloaded
  tensors raise; ``.npz``, ``.pt`` and the ``prefix-%04d.params``
  resolution.
- The tiny detector's inference forward after the import equals the JAX
  forward after the same import (close_to_scale, rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from sniper_tpu.config import default_config
from sniper_tpu.train import pretrained as jpre
from sniper_tpu_torch.convert import _LEAF, convert
from sniper_tpu_torch.models.init import init_detector
from sniper_tpu_torch.train import pretrained as tpre
from test_torch_detector import _perturb
from torch_port import close_to_scale, tiny_jax_detector, \
    tiny_torch_detector

H, W = 64, 96


def _arrays(rng):
    return {
        "arg:conv0_weight": rng.randn(64, 3, 7, 7).astype(np.float32),
        "aux:bn0_moving_mean": rng.randn(64).astype(np.float32),
        "arg:some_fp16": rng.randn(4, 5).astype(np.float16),
        "arg:counts": np.arange(6, dtype=np.int32).reshape(2, 3),
        "arg:scalar": np.float64(2.5),
    }


@pytest.mark.parametrize("writer,reader", [
    (tpre.save_mxnet_params, jpre.read_mxnet_params),
    (jpre.save_mxnet_params, tpre.read_mxnet_params),
    (tpre.save_mxnet_params, tpre.read_mxnet_params)])
def test_params_container_roundtrip(tmp_path, rng, writer, reader):
    arrays = _arrays(rng)
    p = str(tmp_path / "model-0000.params")
    writer(p, arrays)
    back = reader(p)
    assert list(back) == list(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v)
    other = str(tmp_path / "other.params")
    (jpre if writer is tpre.save_mxnet_params else tpre).save_mxnet_params(
        other, arrays)
    with open(p, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    flat = tpre.strip_mx_prefixes(back)
    assert "conv0_weight" in flat and "bn0_moving_mean" in flat


@pytest.mark.parametrize("content", [b"\x00" * 64, "truncated"])
def test_params_reader_rejects_bad_files(tmp_path, rng, content):
    p = str(tmp_path / "bad.params")
    if content == "truncated":
        tpre.save_mxnet_params(p, _arrays(rng))
        with open(p, "rb") as f:
            content = f.read()[:-40]
    with open(p, "wb") as f:
        f.write(content)
    with pytest.raises(tpre.MXParamsError):
        tpre.read_mxnet_params(p)
    with pytest.raises(jpre.MXParamsError):
        jpre.read_mxnet_params(p)


def _to_mx(key, t):
    """A port tensor in MXNet's layout (the inverse of the import's)."""
    a = t.detach().numpy()
    if key in ("rcnn.offset.weight", "rcnn.fc_new_1.weight"):
        out, inp = a.shape
        p = int(round((inp // 256) ** 0.5))
        return a.reshape(out, p, p, 256).transpose(0, 3, 1, 2).reshape(
            out, inp).copy()
    if key == "mask.mask_deconv.weight":
        return a[:, :, ::-1, ::-1].copy()
    return a.copy()


def _port_key(jax_path):
    """A JAX report path ("params", module..., leaf) as a state_dict key."""
    return ".".join(jax_path[1:-1] + (_LEAF[(jax_path[0], jax_path[-1])],))


def _with_mask_tree(variables):
    """The tiny detector's flax variables with the mask branch's params
    added (zeros in flax's layouts, taken from the port's modules): the
    flax init of the mask model costs ~30 s on the CPU, and the imports
    need only the tree."""
    params = dict(variables["params"])
    for key, t in tiny_torch_detector(with_mask=True).state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if not mod.startswith("mask"):
            continue
        shape = tuple(t.shape)
        if leaf == "weight" and len(shape) == 4:  # OIHW, deconv IOHW
            shape = ((shape[2], shape[3], shape[0], shape[1])
                     if mod == "mask.mask_deconv"
                     else (shape[2], shape[3], shape[1], shape[0]))
        elif leaf == "weight":
            shape = shape[::-1]
        node = params
        for part in mod.split("."):
            node[part] = dict(node.get(part, {}))
            node = node[part]
        node["kernel" if leaf == "weight" else leaf] = np.zeros(
            shape, np.float32)
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def imported():
    """One seeded MXNet-layout file of every mapped tensor of the tiny mask
    detector (perturbed, so each matters), imported by both packages."""
    rng = np.random.RandomState(5)
    jmodel, variables = tiny_jax_detector(3)
    variables = _with_mask_tree(variables)
    source = tiny_torch_detector(_perturb(variables, rng), with_mask=True)
    with torch.no_grad():  # non-symmetric kernels: a wrong flip shows
        for name, p in source.named_parameters():
            if name.startswith("mask"):
                p.copy_(torch.randn(p.shape) * 0.05)
    state = source.state_dict()
    rows = tpre.mapping_rows(source)
    flat = {mx: _to_mx(key, state[key]) for key, mx in rows}
    flat["fc1000_weight"] = rng.randn(10, 4).astype(np.float32)  # unused
    dropped = ["rpn_cls_score_bias", "stage2_unit1_bn1_moving_var"]
    for name in dropped:
        del flat[name]
    jvars, jrep = jpre.import_reference_params(flat, variables)
    port = tiny_torch_detector(variables, with_mask=True)
    tstate, trep = tpre.import_reference_params(flat, port)
    return dict(jmodel=jmodel, variables=variables, jvars=jvars, jrep=jrep,
                port=port, tstate=tstate, trep=trep, flat=flat, rows=rows,
                dropped=dropped)


def test_full_mapping_import_matches_jax(imported):
    d = imported
    want = convert(d["jvars"], d["port"])
    assert set(d["tstate"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(d["tstate"][k].numpy(), v.numpy(),
                                      err_msg=k)
    # every mapped tensor but the two dropped ones came from the file
    assert len(d["rows"]) - len(d["dropped"]) == len(d["trep"].loaded)
    jrep, trep = d["jrep"], d["trep"]
    assert {mx for _, mx in trep.loaded} == jrep.loaded_names
    assert {k for k, _ in trep.missing} == {_port_key(p)
                                           for p in jrep.missing}
    assert {mx for _, mx in trep.missing} == set(d["dropped"])
    assert trep.unmapped_keys == jrep.unmapped_keys == ["fc1000_weight"]
    assert not trep.mismatched and not jrep.mismatched
    # the deconv kernel: MXNet's, flipped in both spatial axes (the JAX
    # import's result through convert)
    np.testing.assert_array_equal(
        d["tstate"]["mask.mask_deconv.weight"].numpy(),
        d["flat"]["mask_deconv_weight"][:, :, ::-1, ::-1])
    # the 14x14 pool's offset FC has no reference name: it keeps its init
    assert not any(k.startswith("mask_offset") for k, _ in d["rows"])


def test_forward_after_import_matches_jax(imported):
    """The box detector's forward (the mask branch's is held by
    test_torch_mask on converted weights, and its import above)."""
    d = imported
    model = tiny_torch_detector()
    model.load_state_dict({k: v for k, v in d["tstate"].items()
                           if not k.startswith("mask")})
    jvars = {"params": {k: v for k, v in d["jvars"]["params"].items()
                        if not k.startswith("mask")},
             "batch_stats": d["jvars"]["batch_stats"]}
    rng = np.random.RandomState(6)
    data = rng.randn(2, H, W, 3).astype(np.float32)
    im_info = np.array([[H, W, 1.0], [H - 8, W - 20, 1.0]], np.float32)
    want = d["jmodel"].apply(jvars, data, im_info, train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(data), torch.from_numpy(im_info))
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(want["rois"]),
                               atol=1e-3, rtol=1e-5)
    for k in ("roi_scores", "cls_prob", "bbox_pred"):
        close_to_scale(got[k], want[k])


def _backbone_flat(model, rng):
    """An ImageNet-style file: the trunk's names only, plus a classifier."""
    state = model.state_dict()
    flat = {mx: rng.randn(*state[key].shape).astype(np.float32)
            for key, mx in tpre.mapping_rows(model)
            if key.startswith("trunk.")}
    flat["fc1_weight"] = rng.randn(1000, 2048).astype(np.float32)
    return flat


def test_backbone_only_import_is_selective_reinit(rng):
    # seeded: a deformable unit's conv2_weight is torch.empty until the init,
    # and a NaN there would fail torch.equal against its own clone
    model = init_detector(tiny_torch_detector(), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, report = tpre.import_reference_params(_backbone_flat(model, rng),
                                                 model)
    trunk = {k for k in state if k.startswith("trunk.")}
    assert {k for k, _ in report.loaded} == trunk
    assert report.unmapped_keys == ["fc1_weight"]
    assert {k for k, _ in report.missing} == {
        k for k in state if not k.startswith("trunk.")}
    for k, v in state.items():
        if k in trunk:
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]), k  # the head keeps its init
    # the model itself is untouched until the state is loaded
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _cfg(path, fixed):
    cfg = default_config()
    cfg.network.pretrained = path
    cfg.network.FIXED_PARAMS = fixed
    return cfg


def test_fixed_params_must_be_loaded(tmp_path, rng):
    model = tiny_torch_detector()
    flat = _backbone_flat(model, rng)
    p = str(tmp_path / "backbone-0000.params")
    tpre.save_mxnet_params(p, flat)
    before = model.trunk.conv0.weight.clone()
    with pytest.raises(tpre.MXParamsError, match="FIXED_PARAMS"):
        tpre.load_pretrained(_cfg(p, ["conv0", "rpn"]), model,
                             log=lambda *_: None)
    assert torch.equal(model.trunk.conv0.weight, before)  # nothing loaded
    report = tpre.load_pretrained(
        _cfg(p, ["conv0", "bn0", "stage1", "bn_data"]), model,
        log=lambda *_: None)
    assert len(report.loaded) == len(flat) - 1
    np.testing.assert_array_equal(model.trunk.conv0.weight.detach().numpy(),
                                  flat["conv0_weight"])
    assert tpre.load_pretrained(_cfg("", []), model) is None


def test_shape_mismatch_raises(tmp_path, rng):
    model = tiny_torch_detector()
    flat = _backbone_flat(model, rng)
    flat["conv0_weight"] = flat["conv0_weight"][:32]
    p = str(tmp_path / "bad.npz")
    np.savez(p, **flat)
    with pytest.raises(tpre.MXParamsError, match="conv0_weight"):
        tpre.load_pretrained(_cfg(p, []), model, log=lambda *_: None)


@pytest.mark.parametrize("fmt", ["params", "npz", "pt", "prefix"])
def test_formats_and_prefix_resolution(tmp_path, rng, fmt):
    flat = {"arg:conv0_weight": rng.randn(4, 3, 7, 7).astype(np.float32),
            "aux:bn0_moving_var": rng.rand(4).astype(np.float32)}
    prefix = str(tmp_path / "resnet_mx_101")
    if fmt in ("params", "prefix"):
        path = f"{prefix}-0003.params"
        tpre.save_mxnet_params(path, flat)
    elif fmt == "npz":
        path = f"{prefix}.npz"
        np.savez(path, **flat)
    else:
        path = f"{prefix}.pt"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in flat.items()}}, path)
    if fmt == "prefix":
        assert tpre.resolve_pretrained_path(prefix, 3) == path
        assert jpre.resolve_pretrained_path(prefix, 3) == path
        with pytest.raises(FileNotFoundError):
            tpre.resolve_pretrained_path(prefix, 4)
    got = tpre.load_flat_params(tpre.resolve_pretrained_path(path))
    want = jpre.load_flat_params(path)
    assert set(got) == set(want) == {"conv0_weight", "bn0_moving_var"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
