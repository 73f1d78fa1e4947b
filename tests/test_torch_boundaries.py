"""Boundaries of the PyTorch port: it never imports JAX or the JAX package,
it refuses CUDA when there is none instead of running on the CPU, its CPU
path never counts a kernel launch, and every parameter the slice does not
implement raises NotImplementedError instead of training something else."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.ops import hist_kernel, split_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")


def _data(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def test_import_leaves_jax_out():
    code = (
        "import sys; import lightgbm_tpu_torch, chip_smoke; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_import_anywhere_in_the_port():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightgbm_tpu"), (path, mod)


def test_cuda_asked_for_and_absent_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data()
    with pytest.raises(RuntimeError, match="cuda"):
        tlgb.train({"objective": "binary", "verbose": -1}, tlgb.Dataset(X, label=y), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tlgb.Booster({"objective": "binary", "device": "gpu", "verbose": -1}, tlgb.Dataset(X, label=y))


def test_cpu_path_launches_no_kernel():
    hist_kernel.launches = 0
    split_kernel.launches = 0
    X, y = _data()
    b = tlgb.train(
        {"objective": "binary", "num_leaves": 7, "verbose": -1},
        tlgb.Dataset(X, label=y), 3, device="cpu",
    )
    assert b.num_trees() == 3
    assert hist_kernel.launches == 0 and split_kernel.launches == 0


def test_wrappers_refuse_other_devices():
    bins = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    vals = torch.zeros((8, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        hist_kernel.histogram(bins, vals, 4)
    with pytest.raises(ValueError, match="device"):
        split_kernel.find_best_split_pair(
            torch.zeros((2, 2, 4, 3), device="meta"), None, None, {}, None, None
        )


@pytest.mark.parametrize("params,name", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, "bagging_fraction"),
    ({"feature_fraction": 0.8}, "feature_fraction"),
    ({"boosting": "dart"}, "boosting"),
    ({"objective": "regression"}, "objective"),
    ({"forcedsplits_filename": "f.json"}, "forcedsplits_filename"),
    ({"cegb_penalty_split": 0.1}, "cegb"),
    ({"histogram_pool_size": 1.0}, "histogram_pool_size"),
    ({"tree_learner": "data"}, "tree_learner"),
    ({"tpu_hist_mode": "masked"}, "tpu_hist_mode"),
    ({"tpu_hist_dtype": "bfloat16"}, "tpu_hist_dtype"),
    ({"device_chunk_size": 4}, "device_chunk_size"),
    ({"metric": "l2"}, "metric"),
])
def test_unsupported_params_raise(params, name):
    X, y = _data()
    full = {"objective": "binary", "verbose": -1, **params}
    with pytest.raises(NotImplementedError, match=name):
        tlgb.train(full, tlgb.Dataset(X, label=y), 1, device="cpu")


def test_categorical_and_bundled_data_raise():
    X, y = _data()
    with pytest.raises(NotImplementedError, match="categorical"):
        tlgb.train(
            {"objective": "binary", "verbose": -1},
            tlgb.Dataset(X, label=y, categorical_feature=[0]), 1, device="cpu",
        )
    meta = {"num_bin": np.full(3, 4, np.int32), "missing_type": np.zeros(3, np.int32),
            "default_bin": np.zeros(3, np.int32), "monotone": np.zeros(3, np.int8)}
    ds = convert.binned_from_numpy(np.zeros((3, 10), np.uint8), meta, label=np.zeros(10))
    ds.group_id = np.zeros(3, np.int32)
    ds.bin_offset = np.zeros(3, np.int32)
    cfg = Config.from_params({"objective": "binary", "verbose": -1})
    with pytest.raises(NotImplementedError, match="group_id"):
        GBDT(cfg, ds, create_objective(cfg))
