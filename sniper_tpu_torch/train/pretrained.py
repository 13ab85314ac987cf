"""Pretrained backbone and reference-checkpoint import.

A jax-free copy of sniper_tpu/train/pretrained.py:1-514 for the port's
detector. The reference never trains from scratch: it loads an ImageNet
MXNet backbone and re-initializes only the new detection layers. Here:

- ``read_mxnet_params`` / ``save_mxnet_params``: a NumPy parser and writer
  of MXNet's NDArray-list ``.params`` container (V1/V2/V3 arrays, 4- or
  8-byte shape dims), so that a reference user's
  ``resnet_mx_101-0000.params`` imports with no mxnet;
- ``load_flat_params`` (``.params``, ``.npz``, or a ``torch.save``d flat
  dict in ``.pt`` / ``.pth``) and ``resolve_pretrained_path`` (the
  reference's ``<prefix>-%04d.params`` convention);
- ``import_reference_params``: the MXNet flat names (``conv0_weight``,
  ``stage3_unit12_bn2_gamma``, ``fc_new_1_weight``, ...) onto the port's
  ``state_dict`` keys, which carry the flax tree's module names, so the map
  is the JAX package's ``_mapping_rows`` walked over the port's modules,
  with the same rows: for ResNeXt none for a unit's ``sc_bn``, for
  MobileNetV2 none in the trunk (what the reference's X101 and MNv2
  ``.params`` call those tensors is not settled; ROADMAP.md Queue 3).
  Layouts: MXNet convs are OIHW, as torch's are (``conv2_weight`` too, the
  grouped one of ResNeXt included), and plain FCs are [out, in]: both pass
  unchanged.
  The two FCs that read the pooled feature (``rcnn.offset``,
  ``rcnn.fc_new_1``) go from MXNet's NCHW-flattened [out, C*P*P] to the
  port's [out, P*P*C]. BatchNorm ``_gamma`` / ``_beta`` / ``_moving_mean``
  / ``_moving_var`` become ``weight`` / ``bias`` / ``running_mean`` /
  ``running_var`` (``bn_data`` has no gamma). ``mask_deconv_weight`` gets
  the JAX import's result: the JAX package stores MXNet's [in, out, kh, kw]
  into flax's ConvTranspose without a spatial flip, and ``convert`` then
  flips it into torch's layout, so the port flips it here;
- anything the file lacks keeps its init: the reference's selective
  re-init, since an ImageNet backbone has no ``rpn_*``, ``conv_new_*``,
  ``fc_new_*`` or offset names;
- ``verify_fixed_params``: FIXED_PARAMS may freeze only loaded tensors
  (frozen random weights never train out).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from sniper_tpu_torch.models.norm import FrozenBatchNorm
from sniper_tpu_torch.train.optimizer import is_fixed

# ---------------------------------------------------------------------------
# MXNet .params container (NDArray::Save/Load, mxnet src/ndarray/ndarray.cc)
# ---------------------------------------------------------------------------

_LIST_MAGIC = 0x112  # kMXAPINDArrayListMagic
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA

_MX_DTYPES = {
    0: np.dtype(np.float32), 1: np.dtype(np.float64),
    2: np.dtype(np.float16), 3: np.dtype(np.uint8),
    4: np.dtype(np.int32), 5: np.dtype(np.int8), 6: np.dtype(np.int64),
}
_MX_DTYPE_FLAGS = {v: k for k, v in _MX_DTYPES.items()}


class MXParamsError(ValueError):
    pass


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.off + size > len(self.buf):
            raise MXParamsError("truncated .params file")
        out = struct.unpack_from(fmt, self.buf, self.off)
        self.off += size
        return out if len(out) > 1 else out[0]

    def bytes(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise MXParamsError("truncated .params file")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out


def _plausible_tail(r: _Reader, dims) -> bool:
    """Whether the (dev_type, dev_id, type_flag) triple after a shape is
    valid, without consuming it: tells 4- from 8-byte shape dims apart."""
    try:
        dev_type, dev_id, type_flag = struct.unpack_from("<iii", r.buf, r.off)
    except struct.error:
        return False
    if not all(0 < d < 2**31 for d in dims):
        return False
    return (dev_type in (1, 2, 3, 5, 6) and 0 <= dev_id < 1024
            and type_flag in _MX_DTYPES)


def _read_shape(r: _Reader, ndim: int):
    """Shape dims: int64 each in nnvm-era files, uint32 in legacy ones.
    Try 8-byte first and fall back if the context triple after it does not
    validate."""
    if ndim == 0:
        return ()
    start = r.off
    for fmt, size in (("<%dq" % ndim, 8 * ndim), ("<%dI" % ndim, 4 * ndim)):
        if start + size <= len(r.buf):
            dims = struct.unpack_from(fmt, r.buf, start)
            r.off = start + size
            if _plausible_tail(r, dims):
                return tuple(int(d) for d in dims)
    raise MXParamsError("could not parse NDArray shape")


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.read("<I")
    if magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        stype = r.read("<i")
        if stype not in (0, 1):  # kUndefinedStorage=-1 / kDefaultStorage
            raise MXParamsError(
                f"sparse NDArray storage (stype={stype}) not supported")
        ndim = r.read("<i")
        shape = _read_shape(r, ndim)
    elif magic == _NDARRAY_V1_MAGIC:
        ndim = r.read("<I")
        shape = _read_shape(r, ndim)
    elif magic < 64:  # pre-V1 legacy: the magic word is ndim
        shape = tuple(int(d) for d in r.read("<%dI" % magic)) if magic else ()
    else:
        raise MXParamsError(f"unrecognized NDArray magic 0x{magic:x}")
    _, _, type_flag = r.read("<iii")
    if type_flag not in _MX_DTYPES:
        raise MXParamsError(f"unknown dtype flag {type_flag}")
    dtype = _MX_DTYPES[type_flag]
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    data = np.frombuffer(r.bytes(n * dtype.itemsize), dtype=dtype, count=n)
    return data.reshape(shape).copy()


def read_mxnet_params(path: str) -> dict[str, np.ndarray]:
    """Parse an MXNet ``.params`` file into {name: array}. Names keep the
    ``arg:``/``aux:`` prefixes; see ``strip_mx_prefixes``."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.read("<Q") != _LIST_MAGIC:
        raise MXParamsError(f"{path}: not an MXNet NDArray-list file")
    r.read("<Q")  # reserved
    count = r.read("<Q")
    if count > 1_000_000:
        raise MXParamsError("implausible array count")
    arrays = [_read_ndarray(r) for _ in range(count)]
    n_names = r.read("<Q")
    if n_names != count:
        raise MXParamsError(f"{n_names} names for {count} arrays")
    names = []
    for _ in range(n_names):
        ln = r.read("<Q")
        names.append(r.bytes(ln).decode("utf-8"))
    return dict(zip(names, arrays))


def save_mxnet_params(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write {name: array} in the MXNet V2 NDArray-list format (dense
    float and int arrays; other dtypes are stored as fp32)."""
    out = [struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays))]
    for a in arrays.values():
        a = np.ascontiguousarray(a)
        if a.dtype not in _MX_DTYPE_FLAGS:
            a = a.astype(np.float32)
        out.append(struct.pack("<Ii", _NDARRAY_V2_MAGIC, 0))
        out.append(struct.pack("<i", a.ndim))
        out.append(struct.pack("<%dq" % a.ndim, *a.shape))
        out.append(struct.pack("<iii", 1, 0, _MX_DTYPE_FLAGS[a.dtype]))
        out.append(a.tobytes())
    out.append(struct.pack("<Q", len(arrays)))
    for name in arrays:
        b = name.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def strip_mx_prefixes(flat: dict) -> dict[str, np.ndarray]:
    """Drop the ``arg:``/``aux:`` save prefixes."""
    return {(k[4:] if k.startswith(("arg:", "aux:")) else k): np.asarray(v)
            for k, v in flat.items()}


def load_flat_params(path: str) -> dict[str, np.ndarray]:
    """A flat {mxnet name: array} dict from .params, .npz or .pt/.pth (a
    dict of tensors, or one under "state_dict")."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".params":
        flat = read_mxnet_params(path)
    elif ext == ".npz":
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    elif ext in (".pt", ".pth"):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        flat = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in obj.items()}
    else:
        raise MXParamsError(f"unsupported pretrained format: {path}")
    return strip_mx_prefixes(flat)


def resolve_pretrained_path(prefix: str, epoch: int = 0) -> str:
    """The reference's ``prefix-%04d.params``; a literal existing path (any
    supported extension) also works."""
    if os.path.exists(prefix):
        return prefix
    for cand in (f"{prefix}-{epoch:04d}.params", f"{prefix}.params",
                 f"{prefix}.npz", f"{prefix}-{epoch:04d}.npz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"no pretrained file for prefix {prefix!r} (epoch {epoch})")


# ---------------------------------------------------------------------------
# MXNet name space -> the port's state_dict
# ---------------------------------------------------------------------------

_BN_SUFFIX = {"weight": "gamma", "bias": "beta",
              "running_mean": "moving_mean", "running_var": "moving_var"}


def fc_from_pool(w: np.ndarray, channels: int = 256) -> np.ndarray:
    """An FC over an NCHW-flattened pooled feature, [out, C*P*P], to the
    port's NHWC-flattened [out, P*P*C]."""
    out, inp = w.shape
    p = int(round((inp // channels) ** 0.5))
    if p * p * channels != inp:
        raise MXParamsError(f"cannot infer pooled layout from FC in={inp}")
    return w.reshape(out, channels, p, p).transpose(0, 2, 3, 1).reshape(
        out, inp)


def _deconv_as_jax(w: np.ndarray) -> np.ndarray:
    """MXNet Deconvolution [in, out, kh, kw] as the JAX import leaves it,
    in torch's layout: no tap flip there, so convert's flip shows here."""
    return w[:, :, ::-1, ::-1]


_TRANSFORMS = {"rcnn.offset.weight": fc_from_pool,
               "rcnn.fc_new_1.weight": fc_from_pool,
               "mask.mask_deconv.weight": _deconv_as_jax}


# the trunk modules the JAX import has rows for (_mapping_rows): the stem,
# and in each ``stage*`` unit these children and the unit's own
# ``conv2_weight``
_STEM = ("bn_data", "conv0", "bn0")
_UNIT_CHILDREN = ("bn1", "bn2", "bn3", "conv1", "conv2", "conv3", "sc",
                  "offset")


def _mx_prefix(module_name: str) -> str | None:
    """The MXNet name prefix of a module: the trunk's path joined by "_",
    a head layer's own name (``autofocus.conv_new_2`` -> ``conv_new_2``,
    as the JAX import's rows name it); None for modules the reference has
    no weights for (the 14x14 pool's ``mask_offset``) and for the trunk
    modules the JAX import has no row for: ResNeXt's ``sc_bn`` and every
    module of the MobileNetV2 trunk."""
    parts = module_name.split(".")
    if parts[0] == "trunk":
        stage = len(parts) > 1 and parts[1].startswith("stage")
        if (len(parts) == 2 and (parts[1] in _STEM or stage)) or (
                len(parts) == 3 and stage and parts[2] in _UNIT_CHILDREN):
            return "_".join(parts[1:])
        return None
    if parts[0] in ("rpn", "rcnn", "mask", "autofocus") and len(parts) == 2:
        return parts[1]
    if module_name == "conv_new_1":
        return module_name
    return None


def mapping_rows(model: nn.Module) -> list[tuple[str, str]]:
    """Every (state_dict key, MXNet name) the model can import."""
    keys = set(model.state_dict())
    rows = []
    for mod_name, m in model.named_modules():
        prefix = _mx_prefix(mod_name)
        if prefix is None:
            continue
        leaves = [n for n, _ in m.named_parameters(recurse=False)]
        leaves += [n for n, _ in m.named_buffers(recurse=False)]
        for leaf in leaves:
            if f"{mod_name}.{leaf}" not in keys:
                continue  # a non-persistent buffer
            if isinstance(m, FrozenBatchNorm):
                mx = f"{prefix}_{_BN_SUFFIX[leaf]}"
            else:  # weight, bias, or a deformable unit's conv2_weight
                mx = f"{prefix}_{leaf}"
            rows.append((f"{mod_name}.{leaf}", mx))
    return rows


@dataclass
class ImportReport:
    loaded: list = field(default_factory=list)       # (key, mx_name)
    missing: list = field(default_factory=list)      # (key, mx_name) absent
    mismatched: list = field(default_factory=list)   # (key, mx, got, want)
    unmapped_keys: list = field(default_factory=list)  # file names unused

    def summary(self) -> str:
        return (
            f"loaded {len(self.loaded)} tensors, {len(self.missing)} mapped "
            f"params absent from checkpoint (kept fresh init), "
            f"{len(self.mismatched)} shape mismatches, "
            f"{len(self.unmapped_keys)} checkpoint keys unused")


def import_reference_params(flat: dict, model: nn.Module):
    """Map a flat MXNet-named dict onto ``model``'s state_dict.

    Returns (state_dict, ImportReport): the model's current tensors, with
    those the file holds replaced (the model itself is not changed); a
    tensor whose shape disagrees is reported and left out."""
    state = dict(model.state_dict())
    report = ImportReport()
    consumed = set()
    for key, mx in mapping_rows(model):
        if mx not in flat:
            report.missing.append((key, mx))
            continue
        src = np.asarray(flat[mx])
        try:
            val = _TRANSFORMS[key](src) if key in _TRANSFORMS else src
        except MXParamsError:
            val = src
        want = tuple(state[key].shape)
        if tuple(val.shape) != want:
            report.mismatched.append((key, mx, tuple(val.shape), want))
            continue
        state[key] = torch.tensor(np.ascontiguousarray(val),
                                  dtype=state[key].dtype)
        report.loaded.append((key, mx))
        consumed.add(mx)
    report.unmapped_keys = sorted(k for k in flat if k not in consumed)
    return state, report


def verify_fixed_params(report: ImportReport, model: nn.Module,
                        fixed_prefixes) -> None:
    """Raise if a FIXED_PARAMS prefix would freeze parameters that were not
    loaded from the file."""
    loaded = {k for k, _ in report.loaded}
    problems = [n for n, _ in model.named_parameters()
                if is_fixed(n, fixed_prefixes) and n not in loaded]
    if problems:
        raise MXParamsError(
            f"FIXED_PARAMS freezes {len(problems)} parameters that were NOT "
            f"loaded from the pretrained checkpoint (e.g. "
            f"{', '.join(problems[:8])}); frozen random weights cannot "
            "train: fix network.pretrained or FIXED_PARAMS")


def load_pretrained(cfg, model: nn.Module, log=print):
    """Load ``cfg.network.pretrained`` into ``model`` in place; returns the
    ImportReport, or None when the config names no file (training from
    the init stays supported). Shape mismatches raise, and so do
    FIXED_PARAMS that would freeze unloaded parameters."""
    prefix = str(cfg.network.pretrained or "").strip()
    if not prefix:
        return None
    path = resolve_pretrained_path(prefix, int(cfg.network.pretrained_epoch))
    state, report = import_reference_params(load_flat_params(path), model)
    if report.mismatched:
        raise MXParamsError("pretrained import shape mismatches: " + "; ".join(
            f"{mx}->{key} got {g} want {w}"
            for key, mx, g, w in report.mismatched[:8]))
    verify_fixed_params(report, model, cfg.network.FIXED_PARAMS)
    model.load_state_dict(state)
    log(f"pretrained {path}: {report.summary()}")
    return report
