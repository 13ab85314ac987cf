"""The port's PascalVOC roidb caches are written whole, then renamed into
place, so a data-parallel rank that finds a cache never reads another
rank's half-written pickle.

A writer stopped midway (``pickle.dump`` patched to write part of the
pickle and raise) must leave no file at the cache path; a writer that
finishes leaves the cache and no temporary file, and the cache reads back
as the roidb it stored. Both caches: ``gt_roidb`` and
``selective_search_roidb``. The devkit is tests/test_pascal_voc.py's.
"""

import os
import pickle

import numpy as np
import pytest

from sniper_tpu_torch.data.pascal_voc import PascalVOC
from test_pascal_voc import make_devkit


def _dataset(tmp_path):
    return PascalVOC("2007_test", str(tmp_path), make_devkit(tmp_path))


def _write_ss_mat(tmp_path, ds):
    """A devkit-format selective-search .mat: boxes [y1 x1 y2 x2], 1-based."""
    scipy_io = pytest.importorskip("scipy.io")
    cells = np.empty((2, 1), object)
    cells[0, 0] = np.array([[50, 49, 150, 149], [200, 220, 320, 340]],
                           np.float64)
    cells[1, 0] = np.array([[101, 101, 301, 401]], np.float64)
    os.makedirs(tmp_path / "selective_search_data")
    scipy_io.savemat(
        str(tmp_path / "selective_search_data" / f"{ds.name}.mat"),
        {"boxes": cells})


def _build(tmp_path, which):
    """(the dataset, a call that builds and caches the roidb, its cache)."""
    ds = _dataset(tmp_path)
    cache = os.path.join(str(tmp_path), "cache", f"{ds.name}_{which}_roidb.pkl")
    if which == "gt":
        return ds, lambda: ds.gt_roidb(), cache
    _write_ss_mat(tmp_path, ds)
    gt = ds.gt_roidb(use_cache=False)
    return ds, lambda: ds.selective_search_roidb(gt), cache


def _same_roidb(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


@pytest.mark.parametrize("which", ["gt", "ss"])
def test_voc_cache_is_never_half_written(tmp_path, monkeypatch, which):
    ds, build, cache = _build(tmp_path, which)
    real_dump = pickle.dump

    def dump_half(obj, f, *args, **kw):
        f.write(pickle.dumps(obj)[:64])
        raise OSError("stopped midway")

    monkeypatch.setattr(pickle, "dump", dump_half)
    with pytest.raises(OSError, match="stopped midway"):
        build()
    # a reader finds no cache, builds its own and writes it whole
    assert not os.path.exists(cache)
    monkeypatch.setattr(pickle, "dump", real_dump)
    _same_roidb(build(), build())


@pytest.mark.parametrize("which", ["gt", "ss"])
def test_voc_cache_round_trip(tmp_path, which):
    ds, build, cache = _build(tmp_path, which)
    first = build()
    assert os.path.exists(cache)
    assert not [f for f in os.listdir(os.path.dirname(cache))
                if ".tmp." in f]
    with open(cache, "rb") as f:
        _same_roidb(pickle.load(f), first)
    _same_roidb(build(), first)  # read from the cache
