"""The file-based Dataset of the PyTorch port, against the JAX package, on the
CPU: CSV, TSV and LibSVM files with headers, a label column by index or
``name:`` and the ``.weight``, ``.query`` and ``.init`` sidecars (io.py);
binary files of ``save_binary``, which either package loads from the other
(bundled ones included); ``dump_text`` and ``add_features_from``.

The columns follow tests/test_binning_equiv.py's fixtures (continuous values
rounded to 3 decimals beside heavily repeated ones), with zeros and NaN
added, so the bin bounds are those of its greedy walk.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io import load_text_file as jax_load_text_file
from lightgbm_tpu_torch.basic import _mappers_json
from lightgbm_tpu_torch.io import load_text_file
from lightgbm_tpu_torch.utils.log import LightGBMError


def _columns(n=400, f=4, seed=0):
    rng = np.random.RandomState(seed)
    cols = []
    for _ in range(f):
        heavy = np.repeat(rng.randn(rng.randint(1, 6)), rng.randint(20, 80))
        vals = np.concatenate([rng.randn(n), heavy])[:n]
        rng.shuffle(vals)
        cols.append(np.round(vals, 3))
    X = np.stack(cols, axis=1)
    X[rng.rand(n, f) < 0.05] = 0.0
    X[rng.rand(n, f) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > 0).astype(np.float64)
    return X, y


def _fmt(v):
    return "nan" if np.isnan(v) else "%.17g" % v


def _write_delimited(path, X, y, sep, header, label_at):
    rows = [np.insert(X[i], label_at, y[i]) for i in range(len(X))]
    names = ["f%d" % j for j in range(X.shape[1])]
    names.insert(label_at, "target")
    with open(path, "w") as fh:
        if header:
            fh.write(sep.join(names) + "\n")
        for r in rows:
            fh.write(sep.join(_fmt(v) for v in r) + "\n")


def _write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for i in range(len(X)):
            toks = ["%g" % y[i]] + ["%d:%s" % (j, _fmt(v)) for j, v in enumerate(X[i]) if v != 0.0]
            fh.write(" ".join(toks) + "\n")


def _sidecars(path, n, seed=1):
    rng = np.random.RandomState(seed)
    w = np.round(rng.rand(n) + 0.5, 3)
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(rng.randint(5, 40)), n - sum(sizes)))
    init = np.round(rng.randn(n) * 0.1, 4)
    for kind, vals in (("weight", w), ("query", sizes), ("init", init)):
        with open("%s.%s" % (path, kind), "w") as fh:
            fh.write("\n".join("%.17g" % v for v in vals) + "\n")
    return w, np.asarray(sizes), init


def _assert_same(tds, jds):
    a, b = tds.construct()._binned, jds.construct()._binned
    np.testing.assert_array_equal(a.bins, b.bins)
    assert _mappers_json(a.mappers) == _mappers_json(b.mappers)
    assert a.used_feature_idx == b.used_feature_idx and a.feature_names == b.feature_names
    for field in ("label", "weight", "init_score", "query_boundaries"):
        x, y = getattr(a.metadata, field), getattr(b.metadata, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x, y)
    return a


@pytest.mark.parametrize("fmt,header,label_column", [
    ("csv", False, ""), ("csv", True, "name:target"), ("tsv", True, "2"), ("tsv", False, "1"),
    ("libsvm", False, ""),
])
def test_text_file_bins_and_metadata_equal_jax(tmp_path, fmt, header, label_column):
    X, y = _columns()
    path = str(tmp_path / ("train." + fmt))
    if fmt == "libsvm":
        _write_libsvm(path, X, y)
    else:
        label_at = int(label_column) if label_column.isdigit() else (2 if header else 0)
        _write_delimited(path, X, y, "\t" if fmt == "tsv" else ",", header, label_at)
    w, sizes, init = _sidecars(path, len(X))
    params = {"header": header, "label_column": label_column, "verbose": -1}
    a = _assert_same(tlgb.Dataset(path, params=params), jlgb.Dataset(path, params=params))
    np.testing.assert_array_equal(a.metadata.label, y.astype(np.float32))
    np.testing.assert_array_equal(a.metadata.weight, w.astype(np.float32))
    np.testing.assert_array_equal(np.diff(a.metadata.query_boundaries), sizes)
    np.testing.assert_array_equal(a.metadata.init_score, init)
    if header:
        assert a.feature_names == ["f%d" % j for j in range(X.shape[1])]
    # the rows the file holds are the in-memory Dataset's rows: the same bins
    mem = tlgb.Dataset(X, label=y, params=params).construct()._binned
    np.testing.assert_array_equal(a.bins, mem.bins)


def test_load_text_file_equals_jax(tmp_path):
    cases = {
        "na_first.csv": "NA,1,0\n1.5,2,1\n2.5,3,0\n",
        "auto_header.csv": "label,f0,f1\n1,2.0,3.0\n0,4.0,5.0\n",
        "missing.tsv": "1\t\t3\n0\tnan\tNULL\n1\t2.5\t-0\n",
        "labelled.svm": "1 0:1.5 2:2.0\n0 1:3.0\n",
        "unlabelled.svm": "0:1.5 2:2.0\n1:3.0\n",
    }
    for name, text in cases.items():
        p = tmp_path / name
        p.write_text(text)
        for kw in ({}, {"model_num_features": 5} if name.endswith(".svm") else {}):
            got, want = load_text_file(str(p), **kw), jax_load_text_file(str(p), **kw)
            for g, w in zip(got, want):
                if isinstance(w, np.ndarray):
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w, (name, g, w)


def test_text_file_trains_and_counts_before_construction(tmp_path):
    X, y = _columns(n=300, seed=4)
    path = str(tmp_path / "d.csv")
    _write_delimited(path, X, y, ",", False, 0)
    ds = tlgb.Dataset(path)
    assert ds.num_data() == 300 and ds.num_feature() == 4
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1}, ds, 3, device="cpu")
    mem = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                     tlgb.Dataset(X, label=y), 3, device="cpu")
    np.testing.assert_array_equal(bst.predict(X), mem.predict(X))


def _bundled(n=400, seed=2):
    rng = np.random.RandomState(seed)
    hot = np.zeros((n, 10))
    hot[np.arange(n), rng.randint(0, 10, n)] = rng.randint(1, 4, n)
    X = np.c_[rng.randn(n), hot]
    y = (hot[:, :3].sum(1) + X[:, 0] > 0.8).astype(np.float64)
    return sp.csr_matrix(X), y


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("bundled", [False, True])
def test_binary_file_loads_in_the_other_package(tmp_path, writer, bundled):
    if bundled:
        X, y = _bundled()
    else:
        X, y = _columns(seed=5)
    params = {"verbose": -1, "min_data_in_leaf": 5}
    path = str(tmp_path / "train.bin")
    w = np.linspace(0.5, 1.5, len(y))
    src = (tlgb if writer == "port" else jlgb).Dataset(X, label=y, weight=w, group=[100] * 4,
                                                       params=params)
    src.save_binary(path)
    written = src._binned
    assert written.is_bundled == bundled
    for pkg in (tlgb, jlgb):
        a = pkg.Dataset(path, params=params).construct()._binned
        np.testing.assert_array_equal(a.bins, written.bins)
        assert _mappers_json(a.mappers) == _mappers_json(written.mappers)
        np.testing.assert_array_equal(a.metadata.weight, written.metadata.weight)
        np.testing.assert_array_equal(a.metadata.query_boundaries,
                                      written.metadata.query_boundaries)
        assert a.is_bundled == bundled
        if bundled:
            np.testing.assert_array_equal(a.group_id, written.group_id)
            np.testing.assert_array_equal(a.bin_offset, written.bin_offset)
            assert a.max_group_bins == written.max_group_bins


def test_binary_file_trains_as_the_in_memory_dataset(tmp_path):
    X, y = _columns(n=300, seed=6)
    path = str(tmp_path / "d.bin")
    mem = tlgb.Dataset(X, label=y)
    mem.save_binary(path)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    a = tlgb.train(params, tlgb.Dataset(path), 3, device="cpu")
    b = tlgb.train(params, tlgb.Dataset(X, label=y), 3, device="cpu")
    np.testing.assert_array_equal(a.predict(X), b.predict(X))
    # the label given beside the file takes the place of the file's
    flipped = tlgb.Dataset(path, label=1 - y).construct()._binned
    np.testing.assert_array_equal(flipped.metadata.label, (1 - y).astype(np.float32))


def test_binary_file_with_another_reference_is_fatal(tmp_path):
    X, y = _columns(seed=7)
    path = str(tmp_path / "v.bin")
    tlgb.Dataset(X[:200] * 3.0, label=y[:200]).save_binary(path)
    ref = tlgb.Dataset(X, label=y)
    with pytest.raises(LightGBMError, match="different BinMappers"):
        tlgb.Dataset(path, reference=ref).construct()
    # saved with the reference's mappers, it loads as a validation set
    tlgb.Dataset(X[:200], label=y[:200], reference=ref).save_binary(path)
    valid = tlgb.Dataset(path, reference=ref).construct()._binned
    np.testing.assert_array_equal(valid.bins, ref.construct()._binned.bins[:, :200])


def test_dump_text_equals_jax(tmp_path):
    X, y = _columns(n=50, seed=8)
    path = str(tmp_path / "d.csv")
    _write_delimited(path, X, y, ",", True, 0)
    tlgb.Dataset(path).dump_text(str(tmp_path / "port.txt"))
    jlgb.Dataset(path).dump_text(str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    tlgb.Dataset(X, label=y).dump_text(str(tmp_path / "mem.txt"))
    assert (tmp_path / "mem.txt").read_text() == (tmp_path / "jax.txt").read_text()
    tlgb.Dataset(X, label=y).save_binary(str(tmp_path / "d.bin"))
    with pytest.raises(LightGBMError, match="no raw rows"):
        tlgb.Dataset(str(tmp_path / "d.bin")).dump_text(str(tmp_path / "x.txt"))


def test_add_features_from_equals_jax():
    X, y = _columns(n=300, seed=9)
    Z, _ = _columns(n=300, f=3, seed=10)
    names = ["a", "b", "c", "d"]
    out = []
    for pkg in (tlgb, jlgb):
        left = pkg.Dataset(X, label=y, feature_name=names,
                           params={"monotone_constraints": [1, 0, 0, -1]}).construct()
        right = pkg.Dataset(Z, label=y, feature_name=["a", "e", "a"]).construct()
        out.append(left.add_features_from(right)._binned)
    a, b = out
    np.testing.assert_array_equal(a.bins, b.bins)
    assert a.feature_names == b.feature_names == ["a", "b", "c", "d", "a_1", "e", "a_1_1"]
    assert a.used_feature_idx == b.used_feature_idx
    assert list(a.monotone_constraints) == list(b.monotone_constraints)
    assert a.num_total_features == 7
    with pytest.raises(LightGBMError, match="different number of rows"):
        tlgb.Dataset(X, label=y).construct().add_features_from(
            tlgb.Dataset(Z[:10], label=y[:10]).construct())
    with pytest.raises(LightGBMError, match="must be constructed"):
        tlgb.Dataset(X, label=y).add_features_from(tlgb.Dataset(Z, label=y))
