"""The model text's parameters footer of the port against the JAX package's,
with the observability and flex parameters set.

The JAX ``train`` pops ``flight_record``, ``model_stats``,
``flex_dead_after_s`` and the controller-only flex knobs out of the params
so that the footer stays byte-identical with recording on or off
(lightgbm_tpu/engine.py:88-113). The port pops the same keys: its footer
equals the JAX package's byte for byte but for the ``[device_type: ...]``
line (each package writes its own device), and equals its own footer
without the key. What would record or publish something (a flight log, the
model stats) is not ported yet, so it raises NotImplementedError naming
the parameter, from the params and from the environment alike.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

PARAMS = {"objective": "binary", "verbose": -1, "num_leaves": 7}

#: each popped key with a value that is not its default
POPPED = [
    {"flex_world": 2},
    {"flex_min_world": 2},
    {"flex_max_restarts": 1},
    {"flex_backoff_base_s": 1.5},
    {"flex_backoff_max_s": 5.0},
    {"flex_force_cpu": True},
    {"flex_seed": 7},
    {"flex_max_launches": 3},
    {"flex_journal": "journal.jsonl"},
    {"flex_dead_after_s": 5.0},
    {"model_stats": False},
    {"model_stats": "false"},
    {"flight_record": ""},
]


def _data(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    return X, (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.float64)


def _footer(text):
    """The parameters footer without the ``device_type`` line."""
    footer = text[text.index("\nparameters:"):]
    return "\n".join(line for line in footer.splitlines() if not line.startswith("[device_type:"))


@pytest.fixture(scope="module")
def footers():
    X, y = _data()
    jax_free = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y), 2).model_to_string()
    port_free = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 2,
                           device="cpu").model_to_string()
    return X, y, jax_free, port_free


@pytest.mark.parametrize("extra", POPPED, ids=lambda e: "-".join("%s=%s" % kv for kv in e.items()))
def test_footer_equals_the_jax_package(footers, extra):
    X, y, jax_free, port_free = footers
    params = dict(PARAMS, **extra)
    port = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 2, device="cpu").model_to_string()
    jax = jlgb.train(dict(params), jlgb.Dataset(X, label=y), 2).model_to_string()
    assert _footer(port) == _footer(jax) == _footer(jax_free)
    assert port[port.index("\nparameters:"):] == port_free[port_free.index("\nparameters:"):]
    assert _footer(port_free) == _footer(jax_free)


@pytest.mark.parametrize("params,env,name", [
    ({"flight_record": "flight.jsonl"}, {}, "flight_record"),
    ({}, {"LIGHTGBM_TPU_FLIGHT": "flight.jsonl"}, "flight_record"),
    ({"model_stats": True}, {}, "model_stats"),
    ({"model_stats": "true"}, {}, "model_stats"),
    ({}, {"LIGHTGBM_TPU_MODELSTATS": "1"}, "model_stats"),
])
def test_recording_refuses_by_name(monkeypatch, tmp_path, params, env, name):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    X, y = _data(n=100)
    with pytest.raises(NotImplementedError, match=name):
        tlgb.train(dict(PARAMS, **params), tlgb.Dataset(X, label=y), 1, device="cpu")
    assert not any(tmp_path.iterdir())  # nothing recorded


def test_model_stats_env_off_trains(monkeypatch):
    """``LIGHTGBM_TPU_MODELSTATS=0`` (and an empty one) is off, as in the
    JAX package's ``env_enabled``."""
    X, y = _data(n=100)
    for value in ("0", ""):
        monkeypatch.setenv("LIGHTGBM_TPU_MODELSTATS", value)
        assert tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 1, device="cpu").num_trees() == 1
