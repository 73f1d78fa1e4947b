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
from lightgbm_tpu_torch.ops import cuda_graph, hist_kernel, split_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")


def _data(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def test_import_leaves_jax_out():
    code = (
        "import sys; import lightgbm_tpu_torch, lightgbm_tpu_torch.serve, "
        "lightgbm_tpu_torch.serve.server, lightgbm_tpu_torch.serve.__main__, chip_smoke, "
        "lightgbm_tpu_torch.io, lightgbm_tpu_torch.prediction_early_stop, "
        "lightgbm_tpu_torch.models.model_codegen, lightgbm_tpu_torch.ops.shap_kernel; "
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


def test_server_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    """The server runs on the device it names and refuses to start without
    it, rather than serving on the CPU; so does the CLI."""
    from lightgbm_tpu_torch.serve import __main__ as serve_main
    from lightgbm_tpu_torch.serve.server import ServeApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeApp()
    with pytest.raises(RuntimeError, match="cuda"):
        ServeApp(device="cuda")
    X, y = _data()
    path = str(tmp_path / "m.txt")
    tlgb.train({"objective": "binary", "verbose": -1}, tlgb.Dataset(X, label=y), 1,
               device="cpu").save_model(path)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main.main(["m=" + path, "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        tlgb.Booster(model_file=path, device="cpu").to_packed(device="cuda")


def test_cpu_path_launches_no_kernel():
    cuda_graph.reset_launches()
    X, y = _data()
    train_set = tlgb.Dataset(X, label=y)
    b = tlgb.train(
        {"objective": "binary", "num_leaves": 7, "verbose": -1},
        train_set, 3, valid_sets=[tlgb.Dataset(X[:100], label=y[:100], reference=train_set)],
        verbose_eval=False, device="cpu",
    )
    assert b.num_trees() == 3
    assert not any(cuda_graph.launch_counts().values())


def test_wrappers_refuse_other_devices():
    bins = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    vals = torch.zeros((8, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        hist_kernel.histogram(bins, vals, 4)
    with pytest.raises(ValueError, match="device"):
        split_kernel.find_best_split_pair(
            torch.zeros((2, 2, 4, 3), device="meta"), None, None, {}, None, None
        )


def routed_to_the_host_loop(monkeypatch, n):
    """Freeze every run's histogram route to a table that sends every row
    class of an ``n``-row lattice at 255 bins to ``cuda`` but one, which it
    sends to ``cuda_onehot``: such a run takes the host split loop."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod

    classes = sorted({hist_kernel.rows_bucket(r) for r in hist_kernel.bucket_sizes(n)})
    route = hist_kernel.HistRoute([((255, 3, "float32", r), "cuda_onehot" if i == 0 else "cuda")
                                   for i, r in enumerate(classes)])
    monkeypatch.setattr(gbdt_mod.GBDT, "_resolve_hist_route", lambda self: route)


@pytest.mark.parametrize("params,name", [
    ({"tree_learner": "feature"}, "tree_learner"),
    ({"tree_learner": "voting"}, "tree_learner"),
    ({"forcedsplits_filename": "f.json"}, "forcedsplits_filename on the host split loop"),
    ({"cegb_penalty_split": 0.1}, "cegb_penalty_.* on the host split loop"),
    ({"histogram_pool_size": 0.05}, "histogram_pool_size on the host split loop"),
    ({"tree_learner": "data"}, "tree_learner"),
    ({"tpu_hist_mode": "masked"}, "tpu_hist_mode=masked on the host split loop"),
    ({"tpu_hist_dtype": "float16"}, "tpu_hist_dtype"),
    ({"cegb_penalty_feature_lazy": [1.0] * 6}, "cegb_penalty_.* on the host split loop"),
    ({"cegb_penalty_feature_coupled": [0.5] * 6}, "cegb_penalty_.* on the host split loop"),
])
def test_unsupported_params_raise(monkeypatch, params, name):
    """What the port does not run raises NotImplementedError naming it. Forced
    splits, CEGB, a pool and ``masked`` train on the CPU's default run
    (tests/test_torch_cpu_default.py); they raise on a routed run, which
    takes the host split loop, before the forced-splits file is read."""
    X, y = _data()
    routed_to_the_host_loop(monkeypatch, len(y))
    full = {"objective": "binary", "verbose": -1, "num_leaves": 31, **params}
    with pytest.raises(NotImplementedError, match=name):
        tlgb.train(full, tlgb.Dataset(X, label=y), 1, device="cpu")


def test_two_round_file_loading_raises(tmp_path):
    """A text file with ``two_round`` (the JAX package's streaming loader,
    dist_loader.py) raises NotImplementedError naming it, rather than loading
    the whole file another way."""
    X, y = _data(n=50)
    path = tmp_path / "train.csv"
    path.write_text("".join("%g,%s\n" % (y[i], ",".join("%.17g" % v for v in X[i]))
                            for i in range(len(y))))
    with pytest.raises(NotImplementedError, match="two_round"):
        tlgb.Dataset(str(path), params={"two_round": True}).construct()
    with pytest.raises(NotImplementedError, match="two_round"):
        tlgb.train({"objective": "binary", "two_round": True, "verbose": -1},
                   tlgb.Dataset(str(path)), 1, device="cpu")
    assert tlgb.Dataset(str(path)).construct().num_data() == 50


def test_categorical_data_trains_and_bundled_data_raises():
    """A categorical feature trains (tests/test_torch_categorical.py holds it
    to the JAX package), and so does an EFB-bundled dataset
    (tests/test_torch_efb.py holds it to the JAX package); more than 1024
    bins a feature still raises (up to 1024 trains:
    tests/test_torch_widebin.py)."""
    X, y = _data()
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 3)
    bst = tlgb.train(
        {"objective": "binary", "verbose": -1},
        tlgb.Dataset(X, label=y, categorical_feature=[0]), 1, device="cpu",
    )
    assert bst._gbdt.num_words > 0 and bst._gbdt.feature_meta["is_categorical"][0]
    # one-hot columns as a scipy matrix: bundled, trained with default parameters
    import scipy.sparse as sp

    rng = np.random.RandomState(1)
    hot = rng.randint(0, 8, len(y))
    onehot = np.zeros((len(y), 8))
    onehot[np.arange(len(y)), hot] = 1.0
    y_hot = ((hot % 3 == 0) ^ (rng.rand(len(y)) < 0.1)).astype(np.float64)
    for loop, impl in (("host", None), ("device", "cuda")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(hist_kernel, "_ENV_IMPL", impl)
            bst = tlgb.train({"objective": "binary", "verbose": -1, "min_data_in_leaf": 5},
                             tlgb.Dataset(sp.csr_matrix(onehot), label=y_hot), 2, device="cpu")
        g = bst._gbdt
        assert g.grow_loop == loop and g.num_groups == 1 and g.hist_width == 9
        assert "group_id" in g.feature_meta and bst.num_trees() == 2
        assert set(g._tree_arrays[0].split_feature[:int(g._tree_arrays[0].num_leaves) - 1]
                   .tolist()) <= set(range(8))
        np.testing.assert_array_equal(bst.predict(sp.csr_matrix(onehot)), bst.predict(onehot))
    X_wide, y_wide = _data(n=2400)
    wide = np.c_[np.arange(len(y_wide)) % 1100, X_wide[:, 1:]]
    with pytest.raises(NotImplementedError, match="max_bin: more than 1024 bins"):
        tlgb.train({"objective": "binary", "verbose": -1, "max_bin": 1100, "min_data_in_bin": 1},
                   tlgb.Dataset(wide, label=y_wide), 1, device="cpu")


def test_wide_bundle_and_routed_pool_raise(monkeypatch):
    """Beside wide bins and the pool: an EFB bundle wider than 256 bins (a
    wide feature in a sparse table, int16 groups on the device) trains,
    its trees and model text equal to the JAX package's on dyadic
    gradients (tests/test_torch_efb_wide.py holds its kernels' plain
    versions); a histogram pool on a run whose route sends a row class to
    the host split loop raises, naming its parameter."""
    import scipy.sparse as sp

    import lightgbm_tpu as jlgb
    import lightgbm_tpu.objective as jobj
    import lightgbm_tpu_torch.objective as tobj
    from test_torch_categorical import _exact_gains, _gains_apart
    from test_torch_widebin import _jax_dyadic, _torch_dyadic

    rng = np.random.RandomState(2)
    n = 3000
    hot = np.zeros((n, 6))
    hot[np.arange(n), rng.randint(0, 6, n)] = 1.0
    wide_col = np.where(rng.rand(n) < 0.5, 0.0, np.arange(n) % 400 + 1.0)
    X = sp.csr_matrix(np.c_[wide_col, hot])
    # a noisy label: with a label that is a rule of the features the later
    # gains are f32 rounding, where XLA's fused multiply-adds part the trees
    y = (hot[:, 0] + (wide_col > 200) + 0.7 * rng.randn(n) > 0.5).astype(np.float64)
    params = {"objective": "binary", "verbose": -1, "max_bin": 400, "min_data_in_bin": 1,
              "num_leaves": 15}
    ds = tlgb.Dataset(X, label=y)
    binned = ds.get_binned(tlgb.config.Config.from_params(params))
    assert binned.is_bundled and binned.max_group_bins > 256
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
        mp.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
        tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 3, device="cpu")
        jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), 3)
        exact = _exact_gains(tb, params)
    g = tb._gbdt
    assert g.num_groups > 0 and g.hist_width > 256 and g.bins_dev.dtype == torch.int16
    (jt, jg), (tt, tg) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tt == jt
    # the gains within 8 ulps of the exact gain's terms (tests/test_torch_categorical.py)
    want = np.concatenate([e for e, _ in exact])
    bound = np.concatenate([b for _, b in exact])
    for gains in (tg, jg):
        assert (np.abs(gains - want) <= bound).all()
    # a pool on a routed run: a frozen route that sends every row class to
    # cuda but one, which it sends to cuda_onehot (so to the host loop)
    Xd, yd = _data()
    routed_to_the_host_loop(monkeypatch, len(yd))
    with pytest.raises(NotImplementedError, match="histogram_pool_size on the host split loop"):
        tlgb.train({"objective": "binary", "verbose": -1, "num_leaves": 31,
                    "histogram_pool_size": 0.05}, tlgb.Dataset(Xd, label=yd), 1, device="cpu")
    bst = tlgb.train({"objective": "binary", "verbose": -1, "num_leaves": 31},
                     tlgb.Dataset(Xd, label=yd), 1, device="cpu")
    assert bst._gbdt.grow_loop == "host"


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    """chip_smoke.py prints each kernel's registers and spill bytes from the
    ``-Xptxas -v`` report the build writes beside each library."""
    from lightgbm_tpu_torch.ops import cuda_build

    sym = "_ZN12_GLOBAL__N_115bitplane_kernelILi4ELi4ELb0EEEvPKhxxPKfPKixiixPf"
    log_text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % sym,
        "ptxas info    : Function properties for %s" % sym,
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 5824 bytes smem",
        "ptxas info    : Compiling entry function '_Z11hist_kernelILb1EEvPKhxxPKfPKixiiPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z11hist_kernelILb1EEvPKhxxPKfPKixiiPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z12split_kernelPKf' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 384 bytes cmem[0]",
    ])
    assert cuda_build.ptxas_usage(log_text) == {
        "bitplane_kernel<4,4,0>": {"spill_stores": 8, "spill_loads": 12, "registers": 96},
        "hist_kernel<1>": {"spill_stores": 0, "spill_loads": 0, "registers": 32},
        "split_kernel": {"registers": 40},
    }
    assert cuda_build.kernel_name("not_mangled") == "not_mangled"
