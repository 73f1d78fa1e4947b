"""pandas DataFrames in the PyTorch port, against the JAX package, on the CPU
(the port's copy of tests/test_pandas.py's cases).

``category`` columns become their codes (NaN for missing and unseen
values), the training category lists are kept with the model as the
``pandas_categorical`` line of the model text and applied again at
prediction, and a validation set takes its reference's lists: the coded
matrices, the lists and the predictions equal the JAX package's, and model
text written by either package scores a frame bit for bit in the other.
"""
import functools

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.basic import _data_from_pandas as jax_from_pandas
from lightgbm_tpu_torch.basic import _data_from_pandas as port_from_pandas
from lightgbm_tpu_torch.basic import _mappers_json
from lightgbm_tpu_torch.utils.log import LightGBMError

pd = pytest.importorskip("pandas")

PARAMS = {"objective": "binary", "verbose": -1, "num_leaves": 15}


def _frame(n=200, seed=0):
    rng = np.random.RandomState(seed)
    cat = pd.Series(rng.choice(["lo", "mid", "hi", "peak"], n), dtype="category")
    eff = {"lo": -2.0, "mid": -0.5, "hi": 0.5, "peak": 2.0}
    df = pd.DataFrame({"x0": rng.randn(n), "c": cat, "x1": rng.randn(n),
                       "k": rng.randint(0, 3, n), "b": rng.rand(n) > 0.5})
    y = (df["x0"].to_numpy() + np.asarray([eff[v] for v in cat]) + 0.3 * rng.randn(n)
         > 0).astype(np.float64)
    return df, y


def _train(df, y, rounds=5, **kw):
    return tlgb.train(dict(PARAMS, **kw), tlgb.Dataset(df, label=y), rounds, device="cpu")


@functools.lru_cache(maxsize=None)
def _model_text(writer):
    """The default frame's model text, trained once a file by either package."""
    df, y = _frame()
    if writer == "port":
        return _train(df, y).model_to_string()
    return jlgb.train(PARAMS, jlgb.Dataset(df, label=y), 5).model_to_string()


def test_coded_matrix_and_categories_equal_jax():
    df, _ = _frame()
    df.loc[df.index[:9], "c"] = np.nan
    got, want = port_from_pandas(df), jax_from_pandas(df)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (["x0", "c", "x1", "k", "b"], ["c"],
                                   [["hi", "lo", "mid", "peak"]])
    # prediction: the training lists applied to a frame with another order,
    # an unseen category and a missing value
    other = df.head(8).copy()
    other["c"] = pd.Series(["lo", "new", "hi", None, "mid", "peak", "new", "lo"],
                           dtype="category")
    lists = want[3]
    np.testing.assert_array_equal(port_from_pandas(other, pandas_categorical=lists)[0],
                                  jax_from_pandas(other, pandas_categorical=lists)[0])
    coded = port_from_pandas(other, pandas_categorical=lists)[0][:, 1]
    np.testing.assert_array_equal(coded, [1, np.nan, 0, np.nan, 2, 3, np.nan, 1])
    with pytest.raises(LightGBMError, match="different number of categorical columns"):
        port_from_pandas(other, pandas_categorical=[])


def test_dataset_bins_and_categories_equal_jax():
    df, y = _frame()
    cfg = dict(PARAMS)
    tds, jds = tlgb.Dataset(df, label=y, params=cfg), jlgb.Dataset(df, label=y, params=cfg)
    tds.construct()
    jds.construct()
    assert tds.pandas_categorical == jds.pandas_categorical == [["hi", "lo", "mid", "peak"]]
    np.testing.assert_array_equal(tds._binned.bins, jds._binned.bins)
    assert tds._binned.feature_names == ["x0", "c", "x1", "k", "b"]
    assert tds.num_feature() == 5
    assert _mappers_json(tds._binned.mappers) == _mappers_json(jds._binned.mappers)
    assert tds._binned.mappers[1].bin_type == 1  # the category column bins as categorical


def test_trains_on_a_frame_and_names_its_columns():
    df, y = _frame()
    bst = _train(df, y)
    assert bst.feature_name() == ["x0", "c", "x1", "k", "b"]
    assert bst.pandas_categorical == [["hi", "lo", "mid", "peak"]]
    assert any(t.num_cat > 0 for t in bst._gbdt.trees())
    p = bst.predict(df)
    assert p.shape == (200,) and np.all(np.isfinite(p))
    assert np.mean((p > 0.5) == (y > 0)) > 0.8


def test_category_order_is_stable_across_frames():
    df, _ = _frame()
    bst = tlgb.Booster(model_str=_model_text("port"), device="cpu")
    base = bst.predict(df)
    df2 = df.copy()
    df2["c"] = df2["c"].cat.reorder_categories(["peak", "hi", "mid", "lo"])
    np.testing.assert_array_equal(bst.predict(df2), base)
    df3 = df.copy()
    df3["c"] = pd.Series(list(df["c"].astype(str)), dtype="category")
    np.testing.assert_array_equal(bst.predict(df3), base)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_text_read_by_the_other_package(writer, tmp_path):
    """Model text with a pandas_categorical list, written by either package,
    scores the same frame (unseen and NaN categories included) bit for bit
    in the other, raw, converted and SHAP."""
    df, _ = _frame()
    text = _model_text(writer)
    assert '\npandas_categorical:[["hi", "lo", "mid", "peak"]]\n' in text
    path = tmp_path / "m.txt"
    path.write_text(text)
    tb, jb = tlgb.Booster(model_file=str(path), device="cpu"), jlgb.Booster(model_file=str(path))
    assert tb.pandas_categorical == jb.pandas_categorical
    q = df.head(40).copy()
    q["c"] = q["c"].cat.add_categories(["new"])
    q.loc[q.index[:5], "c"] = "new"
    q.loc[q.index[5:9], "c"] = np.nan
    for kw in ({}, {"raw_score": True}, {"pred_contrib": True}):
        np.testing.assert_array_equal(tb.predict(q, **kw), jb.predict(q, **kw))
    # the port writes the list back as it read it
    assert tb.model_to_string().endswith('\npandas_categorical:[["hi", "lo", "mid", "peak"]]\n')


def test_valid_set_inherits_training_categories():
    df, y = _frame()
    dfv, yv = _frame(n=120, seed=9)
    dfv["c"] = dfv["c"].cat.reorder_categories(["peak", "lo", "hi", "mid"])
    dtr = tlgb.Dataset(df, label=y)
    dva = tlgb.Dataset(dfv, label=yv, reference=dtr)
    res = {}
    bst = tlgb.train(dict(PARAMS, metric="auc"), dtr, 8, valid_sets=[dva], valid_names=["v"],
                     evals_result=res, verbose_eval=False, device="cpu")
    assert dva.pandas_categorical == dtr.pandas_categorical
    np.testing.assert_allclose(bst._gbdt._valid_score_np(0), bst.predict(dfv, raw_score=True),
                               rtol=1e-6, atol=1e-6)
    assert res["v"]["auc"][-1] > 0.8


def test_nan_in_category_column():
    df, y = _frame()
    df.loc[df.index[:30], "c"] = np.nan
    bst = _train(df, y)
    p = bst.predict(df)
    assert np.all(np.isfinite(p))
    text = bst.model_to_string()
    np.testing.assert_array_equal(jlgb.Booster(model_str=text).predict(df), p)


def test_object_column_fails_with_the_jax_message():
    df = pd.DataFrame({"a": [1.0, 2.0], "s": ["x", "y"]})
    with pytest.raises(LightGBMError, match="DataFrame.dtypes must be int, float, bool or category"):
        tlgb.train(PARAMS, tlgb.Dataset(df, label=np.array([0.0, 1.0])), 1, device="cpu")
    with pytest.raises(Exception, match="DataFrame.dtypes must be int, float, bool or category"):
        jlgb.train(PARAMS, jlgb.Dataset(df, label=np.array([0.0, 1.0])), 1)


def test_integer_categories_round_trip_and_timestamps_refuse_to_save():
    """Integer categories go into the model text as JSON numbers and score
    the frame in the other package bit for bit; timestamp categories cannot
    be written as JSON, so saving fails as the JAX package's does, instead of
    writing a list that would map every value to missing."""
    rng = np.random.RandomState(1)
    df = pd.DataFrame({"x": rng.randn(120), "c": pd.Series(rng.randint(0, 4, 120),
                                                          dtype="category")})
    y = ((df["x"] > 0) ^ (df["c"].astype(int) == 2)).astype(np.float64).to_numpy()
    text = _train(df, y, 3).model_to_string()
    assert "\npandas_categorical:[[0, 1, 2, 3]]\n" in text
    np.testing.assert_array_equal(jlgb.Booster(model_str=text).predict(df),
                                  tlgb.Booster(model_str=text, device="cpu").predict(df))
    days = pd.to_datetime(["2024-01-01", "2024-01-02", "2024-01-03"])
    df["c"] = pd.Series(days[rng.randint(0, 3, 120)], dtype="category")
    bst = _train(df, y, 2)
    with pytest.raises(LightGBMError, match="JSON-serializable"):
        bst.model_to_string()
    with pytest.raises(Exception, match="JSON-serializable"):
        jlgb.train(PARAMS, jlgb.Dataset(df, label=y), 2).model_to_string()
