"""The Dataset fields and accessors and the Booster methods of the port
(lightgbm_tpu_torch/basic.py), on the CPU, against the JAX package
(lightgbm_tpu/basic.py:327-519, models/gbdt.py ``shuffle_models``,
models/model_text.py ``dump_model_to_json``).

 * ``set_field`` / ``get_field`` of ``label``, ``weight``, ``init_score``
   and ``group`` (the repair of the port's refusal), and ``set_label``,
   ``set_weight``, ``set_init_score`` and their getters, before and after
   construction: the JAX package's values; a field set after construction
   reaches the binned metadata and the training, as in the JAX package;
 * ``num_feature``, ``get_data`` of a subset, ``set_feature_name``,
   ``set_categorical_feature`` (bins again) and ``get_ref_chain``;
 * ``num_model_per_iteration``, ``feature_name``, ``attr`` / ``set_attr``,
   ``set_train_data_name``, ``get_leaf_output``,
   ``get_split_value_histogram``, ``dump_model`` (the JAX package's dict,
   from the same text, and from the same dyadic training but its gains),
   ``shuffle_models`` (the JAX package's order), ``model_from_string`` and
   ``free_dataset`` (the model still predicts and trains).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.utils.log import LightGBMError as JError
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_boosting import _patch_dyadic
from test_torch_categorical import _gains_apart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRAIN = {"num_leaves": 7, "learning_rate": 0.3, "min_data_in_leaf": 10, "verbose": -1}


def _data(seed=0, n=500, K=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X[:, 0] - 0.6 * X[:, 1] + 0.4 * rng.randn(n)
    if K == 1:
        return X, (z > 0.3).astype(np.float64)
    return X, np.digitize(z, [-0.5, 0.5]).astype(np.float64)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("constructed", [False, True])
@pytest.mark.parametrize("field", ["label", "weight", "init_score", "group", "query"])
def test_fields_equal_jax(field, constructed):
    X, y = _data()
    rng = np.random.RandomState(1)
    value = {"label": 1.0 - y, "weight": rng.rand(len(y)) + 0.5,
             "init_score": rng.randn(len(y)), "group": np.full(50, 10),
             "query": np.full(25, 20)}[field]
    out = []
    for pkg in (jlgb, tlgb):
        ds = pkg.Dataset(X, label=y)
        if constructed:
            ds.construct()
        assert ds.set_field(field, value) is ds
        got = [ds.get_field(field)] + [ds.get_field(f) for f in ("label", "weight", "init_score")]
        if constructed:
            md = ds._binned.metadata
            got += [md.label, md.weight, md.init_score]
        out.append(got)
    for a, b in zip(*out):
        _same(b, a)


def test_field_setters_and_errors():
    X, y = _data()
    rng = np.random.RandomState(2)
    w, init = rng.rand(len(y)) + 0.5, rng.randn(len(y))
    for pkg, err in ((jlgb, JError), (tlgb, LightGBMError)):
        ds = pkg.Dataset(X).set_label(y).set_weight(w).set_init_score(init)
        assert ds.get_label() is y and ds.get_weight() is w and ds.get_init_score() is init
        ds.construct()
        assert ds.get_label().dtype == np.float32
        with pytest.raises(err, match="Unknown field name"):
            ds.set_field("position", y)
        with pytest.raises(err, match="Unknown field name"):
            ds.get_field("position")
        with pytest.raises(err, match="Initial score size"):
            ds.set_init_score(init[:-7])


def test_fields_set_after_construction_train_as_jax(monkeypatch):
    """Labels, weights and init scores set on a constructed Dataset are the
    ones the Booster trains on: the JAX package's model (dyadic gradients)."""
    _patch_dyadic(monkeypatch)
    X, y = _data(3)
    w = np.round(np.random.RandomState(3).rand(len(y)) * 4 + 1) / 2
    texts = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=np.zeros(len(y))).construct()
        ds.set_field("label", y)
        ds.set_field("weight", w)
        ds.set_field("init_score", np.full(len(y), 0.25))
        bst = pkg.train(dict(TRAIN, objective="binary"), ds, 3, verbose_eval=False, **kw)
        texts.append(_gains_apart(bst.model_to_string())[0])
    assert texts[1] == texts[0]


def test_dataset_accessors():
    X, y = _data(4, 300)
    ds = tlgb.Dataset(X, label=y)
    assert ds.num_feature() == 5 and ds.num_data() == 300
    sub = ds.subset(np.arange(10, 60))
    np.testing.assert_array_equal(sub.get_data(), X[10:60])
    assert sub.num_data() == 50 and sub.num_feature() == 5
    valid = ds.create_valid(X[:40], label=y[:40])
    assert valid.get_ref_chain() == {valid, ds} and ds.get_ref_chain() == {ds}
    ds.set_feature_name(["a", "b", "c", "d", "e"]).construct()
    assert ds._binned.feature_names == ["a", "b", "c", "d", "e"]
    with pytest.raises(LightGBMError, match="Length of feature_name"):
        ds.set_feature_name(["a"])
    Xc = np.c_[X, np.random.RandomState(5).randint(0, 4, 300)]
    cat = tlgb.Dataset(Xc, label=y).construct()
    assert "is_categorical" not in cat._binned.feature_meta_arrays()
    cat.set_categorical_feature([5])
    assert cat._binned is None
    assert cat.construct()._binned.feature_meta_arrays()["is_categorical"][5]


def _pair_models(monkeypatch, K=1, **params):
    _patch_dyadic(monkeypatch)
    X, y = _data(6, 600, K)
    p = dict(TRAIN, objective="binary" if K == 1 else "multiclass", **params)
    if K > 1:
        p["num_class"] = K
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y, feature_name=list("abcde")), 5,
                    verbose_eval=False)
    tb = tlgb.train(dict(p), tlgb.Dataset(X, label=y, feature_name=list("abcde")), 5,
                    verbose_eval=False, device="cpu")
    return jb, tb, X, y


def _no_gains(d):
    if isinstance(d, dict):
        return {k: _no_gains(v) for k, v in d.items() if k != "split_gain"}
    if isinstance(d, list):
        return [_no_gains(v) for v in d]
    return d


@pytest.mark.parametrize("K", [1, 3])
def test_booster_methods_equal_jax(monkeypatch, K):
    jb, tb, X, y = _pair_models(monkeypatch, K)
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration() == K
    assert tb.feature_name() == jb.feature_name() == list("abcde")
    for i in range(tb.num_trees()):
        for leaf in range(3):
            assert tb.get_leaf_output(i, leaf) == jb.get_leaf_output(i, leaf)
    for feature in (0, "b", 3):
        for bins in (None, 4):
            (tc, te), (jc, je) = (tb.get_split_value_histogram(feature, bins),
                                  jb.get_split_value_histogram(feature, bins))
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(te, je)
    with pytest.raises(LightGBMError, match="Unknown feature name"):
        tb.get_split_value_histogram("z")
    # dump_model: equal but the gains from the trainings; equal whole from one text
    assert _no_gains(tb.dump_model()) == _no_gains(jb.dump_model())
    assert _no_gains(tb.dump_model(2)) == _no_gains(jb.dump_model(2))
    text = tb.model_to_string()
    assert (tlgb.Booster(model_str=text, device="cpu").dump_model()
            == jlgb.Booster(model_str=text).dump_model())
    # shuffle_models: the JAX package's order
    tb.shuffle_models(1, 4)
    jb.shuffle_models(1, 4)
    assert _gains_apart(tb.model_to_string())[0] == _gains_apart(jb.model_to_string())[0]
    np.testing.assert_array_equal(tb.predict(X, num_iteration=2), jb.predict(X, num_iteration=2))


def test_attributes_names_and_model_from_string(monkeypatch):
    jb, tb, X, y = _pair_models(monkeypatch)
    for b in (jb, tb):
        assert b.attr("k") is None
        b.set_attr(k="v", other="w")
        assert b.attr("k") == "v"
        b.set_attr(k=None)
        assert b.attr("k") is None and b.attr("other") == "w"
    with pytest.raises(LightGBMError, match="string"):
        tb.set_attr(k=1)
    ds = tb.train_set
    assert tb.set_train_data_name("fit").eval_train()[0][0] == "fit"
    assert tb.eval(ds, "x")[0][0] == "fit"
    fresh = tlgb.Booster(dict(TRAIN, objective="binary"), tlgb.Dataset(X, label=y), device="cpu")
    fresh.model_from_string(tb.model_to_string(), verbose=False)
    assert fresh.model_to_string() == tb.model_to_string() and fresh.train_set is None
    np.testing.assert_array_equal(fresh.predict(X), tb.predict(X))


def test_free_dataset_keeps_the_model(monkeypatch):
    _, tb, X, y = _pair_models(monkeypatch)
    Xv, yv = _data(8, 200)
    tb.add_valid(tlgb.Dataset(Xv, label=yv), "v")
    before = tb.predict(X)
    tb.free_dataset()
    assert tb.train_set is None and tb._valid_datasets == []
    np.testing.assert_array_equal(tb.predict(X), before)
    tb.update()
    assert tb.current_iteration == 6 and [e[0] for e in tb.eval_valid()] == ["v"]
