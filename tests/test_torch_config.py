"""The port's config system and config files against the JAX package's.

Every config file of the JAX package has a copy in the port; both
``Config.from_file``s resolve each to the same dict (exact equality), and
the copies differ from the originals in comment lines only. ``merge_dicts``
(with ``_delete_``), ``apply_typed_config`` (strict and lax) and
``model_config_from_cfg`` give the same results on both sides (equal
values, field by field).
"""

import dataclasses
import io
import os
import tokenize

import pytest

from fgn_tpu.config import Config as JConfig
from fgn_tpu.config import apply_typed_config as j_apply
from fgn_tpu.config.core import merge_dicts as j_merge
from fgn_tpu.main import batch_heuristic as j_batch_heuristic
from fgn_tpu.main import model_config_from_cfg as j_model_cfg
from fgn_torch.config import Config, FGNConfig, apply_typed_config, merge_dicts
from fgn_torch.main import batch_heuristic, model_config_from_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_DIR = os.path.join(ROOT, "fgn_tpu", "configs")
T_DIR = os.path.join(ROOT, "fgn_torch", "configs")
NAMES = sorted(f for f in os.listdir(J_DIR) if f.endswith(".py"))


def test_fifty_configs_each_copied():
    assert len(NAMES) == 50
    assert sorted(f for f in os.listdir(T_DIR) if f.endswith(".py")) == NAMES


def _code_tokens(fp):
    """The file's tokens without comments and layout-only tokens."""
    with open(fp) as f:
        toks = tokenize.generate_tokens(io.StringIO(f.read()).readline)
        return [(t.type, t.string) for t in toks
                if t.type not in (tokenize.COMMENT, tokenize.NL,
                                  tokenize.NEWLINE, tokenize.INDENT,
                                  tokenize.DEDENT)]


@pytest.mark.parametrize("name", NAMES)
def test_config_file_resolves_equal(name):
    want = JConfig.from_file(os.path.join(J_DIR, name))
    got = Config.from_file(os.path.join(T_DIR, name))
    assert isinstance(got, Config)
    assert got == want
    assert _code_tokens(os.path.join(T_DIR, name)) == _code_tokens(
        os.path.join(J_DIR, name))


@pytest.mark.parametrize("override", [
    {"m": {"y": 5}, "k": 4},
    {"m": {"_delete_": True, "z": 9}},
    {"m": {"n": {"_delete_": True}}, "new": [1, {"a": 2}]},
    {"m": 7},
], ids=["recursive", "delete", "nested_delete", "replace"])
def test_merge_dicts_equals_jax(override):
    base = {"m": {"x": 1, "y": 2, "n": {"p": 1}}, "k": 3}
    got = merge_dicts(base, override)
    assert got == j_merge(base, override)
    assert base == {"m": {"x": 1, "y": 2, "n": {"p": 1}}, "k": 3}


class _Typed:
    x = 1
    name = "a"
    ratio = 0.5


@pytest.mark.parametrize("cfg,strict", [
    ({"x": 3, "ratio": 0.25, "new_key": [1]}, True),
    ({"ratio": 1}, True),
    ({"name": 5}, True),
    ({"name": 5, "x": "seven"}, False),
], ids=["typed", "int_for_float", "strict_rejects", "lax"])
def test_apply_typed_config_equals_jax(cfg, strict):
    outcomes = []
    for apply in (apply_typed_config, j_apply):
        obj = _Typed()
        try:
            apply(obj, dict(cfg), strict=strict)
            outcomes.append(("ok", dict(vars(obj))))
        except TypeError as e:
            outcomes.append(("TypeError", str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("name", ["fgn_r50_c4_densecl.py",
                                  "fgn_train_mnistiseg_n3k3.py",
                                  "fgn_train_coco2voc.py"])
def test_model_config_from_cfg_equals_jax(name):
    cfg = Config.from_file(os.path.join(T_DIR, name))
    cfg.model["bogus_key"] = 1  # unknown keys are ignored on both sides
    got = model_config_from_cfg(cfg)
    want = j_model_cfg(JConfig.from_file(os.path.join(J_DIR, name)))
    assert isinstance(got, FGNConfig)
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in dataclasses.fields(want)})
    for f in dataclasses.fields(FGNConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_batch_heuristic_equals_jax():
    for n, k in ((1, 1), (3, 1), (3, 3), (6, 5)):
        assert batch_heuristic(n, k) == j_batch_heuristic(n, k)
