"""Measured histogram routing of the port on the CPU: the tune tables and
their exchange with the JAX package, ``active_table``, ``resolve_route``,
the dispatch precedence and the cap fallback, and the sweep's shapes.

 * A table the port writes passes the JAX package's ``load_table`` and one
   the JAX package builds passes the port's; a torn file, another schema
   or a bad digest raises.
 * ``active_table``: an explicit path raises on failure; the env path warns
   and falls back; ``"off"`` disables both.
 * ``resolve_route`` drops tables of other backends and device families,
   and entries whose impl does not serve their shape there.
 * ``pick_impl``: explicit > LIGHTGBM_TPU_HIST_IMPL > route > default; a
   capped-out impl warns once, counts ``hist_impl_fallback_total`` and
   takes the device's default (the ``cuda`` kernel on CUDA).
"""
import json

import pytest
import torch

from lightgbm_tpu.obs import tune as jtune
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.obs import tune as ttune
from lightgbm_tpu_torch.obs.costs import normalize_device_kind
from lightgbm_tpu_torch.obs.registry import REGISTRY
from lightgbm_tpu_torch.ops import hist_kernel as hk
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

CUDA = torch.device("cuda")  # a device object only: nothing is allocated on it


def _entries(impls=("cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4")):
    return [
        {"B": 15, "K": 3, "hist_dtype": "float32", "rows_bucket": r, "impl": impl}
        for r, impl in zip((256, 384, 512, 768), impls)
    ]


def _cuda_table(family="h100", impls=("cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4")):
    return ttune.build_table(
        _entries(impls), backend="cuda", device_kind="NVIDIA H100 80GB HBM3",
        device_family=family,
    )


@pytest.fixture
def h100(monkeypatch):
    """Make a cuda device object report the H100 family."""
    monkeypatch.setattr(hk, "device_family", lambda d: "h100" if d.type == "cuda" else "cpu")


def test_table_written_by_the_port_loads_in_jax(tmp_path):
    path = str(tmp_path / "t.json")
    ttune.save_table(_cuda_table(), path)
    loaded = jtune.load_table(path)
    assert loaded["backend"] == "cuda" and loaded["device_family"] == "h100"
    assert loaded["digest"] == ttune.load_table(path)["digest"]
    # a cuda table never routes a JAX run
    assert jhist.resolve_route(loaded, source=path) is None


def test_table_built_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "j.json")
    ents = [{"B": 63, "K": 3, "hist_dtype": "float32", "rows_bucket": 1024, "impl": "scatter"},
            {"B": 63, "K": 3, "hist_dtype": "float32", "rows_bucket": 2048, "impl": "xla"}]
    jtune.save_table(jtune.build_table(ents, backend="cpu", device_family="cpu"), path)
    table = ttune.load_table(path)
    assert table["entries"] == ents
    # on the CPU its scatter entry survives, the XLA program is dropped
    route = hk.resolve_route(table, torch.device("cpu"), source=path)
    assert route.entries == (((63, 3, "float32", 1024), "scatter"),)
    # and it never routes a CUDA run
    assert hk.resolve_route(table, CUDA) is None


@pytest.mark.parametrize("damage", ["torn", "digest", "schema", "entries"])
def test_damaged_tables_raise(tmp_path, damage):
    path = tmp_path / "t.json"
    table = _cuda_table()
    text = json.dumps(table)
    if damage == "torn":
        text = text[: len(text) // 2]
    elif damage == "digest":
        table["entries"][0]["impl"] = "cuda_onehot"
        text = json.dumps(table)
    elif damage == "schema":
        table["schema"] = 2
        text = json.dumps(table)
    else:
        table["entries"] = {}
        text = json.dumps(table)
    path.write_text(text)
    with pytest.raises(LightGBMError):
        ttune.load_table(str(path))
    with pytest.raises(Exception):
        jtune.load_table(str(path))


def test_active_table_precedence(tmp_path, monkeypatch):
    good = str(tmp_path / "good.json")
    ttune.save_table(_cuda_table(), good)
    bad = str(tmp_path / "missing.json")
    log.reset_warn_once()
    monkeypatch.setattr(log, "_level", "warning")  # a verbose=-1 training may have raised it
    monkeypatch.delenv(ttune.ENV_PATH, raising=False)
    assert ttune.active_table("") == (None, "")
    assert ttune.active_table(good)[1] == good
    with pytest.raises(LightGBMError):
        ttune.active_table(bad)  # explicit: the user asked for this table
    monkeypatch.setenv(ttune.ENV_PATH, bad)
    lines = []
    log.register_callback(lines.append)
    try:
        assert ttune.active_table("") == (None, "")  # ambient: warn and go on
    finally:
        log.register_callback(None)
    assert any("could not be loaded" in ln for ln in lines)
    monkeypatch.setenv(ttune.ENV_PATH, good)
    assert ttune.active_table("")[1] == good
    assert ttune.active_table("off") == (None, "")  # disables the env too
    monkeypatch.setenv(ttune.ENV_PATH, "off")
    assert ttune.active_table("") == (None, "")


def test_resolve_route_filters(h100):
    route = hk.resolve_route(_cuda_table(), CUDA, source="t")
    assert len(route.entries) == 4 and route.source == "t"
    assert route.pick(300, 15, 3, "float32") == "cuda_onehot"  # 300 -> class 384
    assert route.pick(300, 15, 3, "bfloat16") is None
    # other device family, other backend
    assert hk.resolve_route(_cuda_table(family="a100"), CUDA) is None
    assert hk.resolve_route(_cuda_table(), torch.device("cpu")) is None
    tpu = jtune.build_table(_entries(("pallas",) * 4), backend="tpu", device_family="v5e")
    assert hk.resolve_route(tpu, CUDA) is None
    # capped-out impls and the plain version are dropped on CUDA
    wide = ttune.build_table(
        [{"B": 255, "K": 3, "hist_dtype": "float32", "rows_bucket": 256, "impl": "cuda_packed4"},
         {"B": 255, "K": 3, "hist_dtype": "float32", "rows_bucket": 384, "impl": "scatter"},
         {"B": 255, "K": 3, "hist_dtype": "float32", "rows_bucket": 512, "impl": "cuda_bitplane"}],
        device_family="h100",
    )
    assert hk.resolve_route(wide, CUDA).entries == (((255, 3, "float32", 512), "cuda_bitplane"),)
    assert hk.resolve_route({"entries": []}, CUDA) is None


def test_hist_route_value_semantics():
    a = hk.HistRoute([((15, 3, "float32", 256), "cuda"), ((15, 3, "float32", 384), "cuda_onehot")])
    b = hk.HistRoute([((15, 3, "float32", 384), "cuda_onehot"), ((15, 3, "float32", 256), "cuda")])
    assert a == b and hash(a) == hash(b) and a.digest == b.digest
    assert hk.HistRoute([((15, 3, "float32", 256), "cuda")] * 2) == hk.HistRoute(
        [((15, 3, "float32", 256), "cuda")]
    )
    with pytest.raises(LightGBMError, match="conflicting"):
        hk.HistRoute([((15, 3, "float32", 256), "cuda"), ((15, 3, "float32", 256), "cuda_onehot")])


def test_pick_impl_precedence(monkeypatch):
    route = hk.HistRoute([((63, 3, "float32", 1024), "cuda_bitplane")])
    pick = hk.pick_impl
    monkeypatch.setattr(hk, "_ENV_IMPL", "")
    assert pick("auto", 1000, 63, 3, "float32", None, "cuda") == "cuda"
    assert pick("auto", 1000, 63, 3, "float32", None, "cpu") == "scatter"
    assert pick("auto", 1000, 63, 3, "float32", route, "cuda") == "cuda_bitplane"
    assert pick("auto", 1025, 63, 3, "float32", route, "cuda") == "cuda"  # class 1536
    monkeypatch.setattr(hk, "_ENV_IMPL", "cuda_onehot")
    assert pick("auto", 1000, 63, 3, "float32", route, "cuda") == "cuda_onehot"
    assert pick("cuda", 1000, 63, 3, "float32", route, "cuda") == "cuda"
    with pytest.raises(ValueError, match="impl"):
        pick("pallas", 1000, 63, 3, "float32", None, "cuda")


@pytest.mark.parametrize("backend,default", [("cuda", "cuda"), ("cpu", "scatter")])
def test_capped_out_impl_warns_once_and_counts(monkeypatch, backend, default):
    monkeypatch.setattr(hk, "_ENV_IMPL", "")
    monkeypatch.setattr(log, "_level", "warning")  # a verbose=-1 training may have raised it
    log.reset_warn_once()
    counter = REGISTRY.counter("hist_impl_fallback_total")
    before = counter.value(requested="cuda_packed4")
    lines = []
    log.register_callback(lines.append)
    try:
        for _ in range(3):
            assert hk.pick_impl("cuda_packed4", 500, 255, 3, "float32", None, backend) == default
    finally:
        log.register_callback(None)
    assert len([ln for ln in lines if "cuda_packed4" in ln]) == 1
    assert counter.value(requested="cuda_packed4") == before + 3
    # the plain version asked for on CUDA lands on the kernel too
    assert hk.pick_impl("scatter", 500, 255, 3, "float32", None, "cuda") == "cuda"


def test_env_outside_the_vocabulary_is_ignored(monkeypatch):
    from lightgbm_tpu_torch.utils.env import env_choice

    monkeypatch.setenv("LIGHTGBM_TPU_HIST_IMPL", "pallas")
    with pytest.warns(UserWarning, match="not recognized"):
        assert env_choice("LIGHTGBM_TPU_HIST_IMPL", hk.IMPLS) == ""
    monkeypatch.setenv("LIGHTGBM_TPU_HIST_IMPL", "CUDA_Onehot")
    assert env_choice("LIGHTGBM_TPU_HIST_IMPL", hk.IMPLS) == "cuda_onehot"


def test_sweep_shapes_and_candidates():
    shapes = ttune.sweep_shapes(100_000, [15, 255], 28, dtypes=["float32", "bfloat16"])
    jshapes = jtune.sweep_shapes(100_000, [15, 255], 28, dtypes=["float32", "bfloat16"])
    assert shapes == jshapes
    assert max(s["rows"] for s in shapes) == hk.rows_bucket(100_000)
    assert ttune.candidate_impls(15) == ["cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4"]
    assert ttune.candidate_impls(255) == ["cuda", "cuda_onehot", "cuda_bitplane"]
    assert ttune.candidate_impls(255, "cpu") == ["scatter"]


def test_sweep_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttune.main(["--out", str(tmp_path / "t.json"), "--rows", "1000", "--bins", "15"])
    assert not (tmp_path / "t.json").exists()


@pytest.mark.parametrize("name,family", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"), ("NVIDIA H200", None),
    ("NVIDIA GH200 480GB", None), ("NVIDIA A100-SXM4-80GB", None), ("Some Card", None),
    ("", None),
])
def test_normalize_device_kind(name, family):
    assert normalize_device_kind(name) == family
