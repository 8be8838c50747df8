"""The port's config layer against the JAX package's, on the CPU: the YAML
reader against PyYAML's FullLoader (what the JAX package loads with), the
key audit, and the loop's render and NeRF configs from an experiment.

Tolerances: none; every value is compared for equality (floats as Python
floats, NaN as NaN).
"""

import glob
import math
import os
import warnings

import pytest
import yaml

from ucsa_neural_rendering_tpu.config import key_audit as jaudit
from ucsa_neural_rendering_tpu.config import loading as jloading
from ucsa_neural_rendering_tpu.config.flatten_dict import \
    flatten_dict as jflatten
from ucsa_neural_rendering_tpu.train import joint_loop as jloop
from ucsa_neural_rendering_tpu_torch.config import key_audit as taudit
from ucsa_neural_rendering_tpu_torch.config import loading as tloading
from ucsa_neural_rendering_tpu_torch.config.flatten_dict import \
    flatten_dict as tflatten
from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
from ucsa_neural_rendering_tpu_torch.train import joint_loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILES = sorted(glob.glob(os.path.join(ROOT, "cfg", "**", "*.yml"),
                             recursive=True))
EXP_FILES = [p for p in CFG_FILES if os.sep + "exp" + os.sep in p]
JOINT_FILES = [p for p in EXP_FILES
               if "one_step_joint" in p or "multi_step" in p]
rel = lambda p: os.path.relpath(p, ROOT)


def _pyyaml(text):
    return yaml.load(text, Loader=yaml.FullLoader)


def _same(a, b):
    """Equal values of equal types (bool is not int, NaN equals NaN)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same(k, l) and _same(a[k], b[l]) for k, l in zip(a, b))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_cfg_tree_holds_yaml_files():
    assert len(CFG_FILES) >= 20 and len(JOINT_FILES) >= 12


@pytest.mark.parametrize("path", CFG_FILES, ids=rel)
def test_yaml_reader_matches_pyyaml(path):
    """Every cfg/**/*.yml reads as PyYAML's FullLoader reads it, and
    load_exp_and_env gives the JAX package's (exp, env, paths)."""
    text = open(path).read()
    assert _same(tloading.parse_yaml(text, path), _pyyaml(text))
    assert _same(tloading.load_yaml(path), jloading.load_yaml(path))
    if path in EXP_FILES:
        got = tloading.load_exp_and_env(ROOT, rel(path), "env")
        ref = jloading.load_exp_and_env(ROOT, rel(path), "env")
        assert _same(list(got), list(ref))


SCALARS = [
    "a: 1e-5", "a: 1.0e-5", "a: 1.0e5", "a: 1.0E+5", "a: 1.", "a: .5",
    "a: -.5", "a: +1", "a: -1", "a: 0", "a: -0", "a: 00", "a: 010",
    "a: 0x1F", "a: 0b101", "a: 1_000", "a: 1_0.5", "a: 190:20:30",
    "a: 1:30.5", "a: 12:30", "a: .inf", "a: -.Inf", "a: .NaN", "a: NaN",
    "a: yes", "a: Yes", "a: NO", "a: on", "a: Off", "a: true", "a: FALSE",
    "a: y", "a: ~", "a:", "a: null", "a: Null", "a: nul", "a: '1.0'",
    "a: \"1.0\"", "a: 'it''s'", "a: \"tab\\there \\\"q\\\" \\u00e9\\x41\"",
    "a: b # c", "a: b#c", "a: # c", "a: 'x' # c", "a: /*/color/*.jpg",
    "a: ckpts/pretrained_deeplab", "a: http://x.org/y", "25k_fraction: 0.1",
    "1: x", "true: 1", "'a b': 2", "\"k\": v", "---\na: 1", "a: 1\na: 2",
    "a:\n- 1\n- 2\nb: 3", "a:\n  - x: 1\n    y: 2\n  - z\n", "- a\n- b",
    "a:\n  b:\n    c: d\n  e: f\ng: h", "a:\n-\n  b: 1", "-\n  - 1\n  - 2",
    "a:\n  - 1\n\n  # comment\n  - 2   # two\n", "", "# only a comment\n",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_resolve_as_pyyaml(text):
    """Plain scalars resolve as YAML 1.1 under FullLoader (a float needs a
    dot, the exponent a sign), quoted ones stay strings, comments go."""
    assert _same(tloading.parse_yaml(text), _pyyaml(text)), (
        tloading.parse_yaml(text), _pyyaml(text))


OUTSIDE = {
    "a: [1, 2]": (1, "flow collection"),
    "a: {b: 1}": (1, "flow collection"),
    "a: |\n  x": (1, "block scalar"),
    "a: >\n  x": (1, "block scalar"),
    "a: &x 1": (1, "anchor"),
    "b: 1\na: *x": (2, "alias"),
    "a: !!str 1": (1, "tag"),
    "a: b\n  c": (2, "over several lines"),
    "a: 2001-12-14": (1, "timestamp"),
    "a: b: c": (1, "mapping inside a plain scalar"),
    "a: \"x\n  y\"": (1, "quoted scalar over several lines"),
    "a:\n\tb: 1": (2, "tab"),
    "<<: 1": (1, "merge"),
    "a:\n  - 1\n   - 2": (3, "indentation"),
    "a: 1\n---\nb: 2": (2, "further documents"),
    "a: 'x' y": (1, "text after a quoted scalar"),
    "a: \"\\q\"": (1, "escape"),
    "x\ny: 1": (2, "over several lines"),
}


@pytest.mark.parametrize("text", list(OUTSIDE))
def test_yaml_outside_the_subset_raises_naming_the_line(text):
    line, what = OUTSIDE[text]
    with pytest.raises(tloading.YAMLSubsetError) as e:
        tloading.parse_yaml(text, "t.yml")
    assert f"t.yml:{line}:" in str(e.value) and what in str(e.value)


def test_load_env_takes_an_absolute_name(tmp_path):
    """ENV_WORKSTATION_NAME as a name under cfg/env, or an absolute path
    without .yml, as the JAX package's os.path.join resolves it."""
    (tmp_path / "mine.yml").write_text("results: /r\nscannet: /s\n")
    for name in ("env", str(tmp_path / "mine")):
        assert _same(tloading.load_env(ROOT, name),
                     jloading.load_env(ROOT, name))


def _audit(mod, exp, entry):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = mod.audit_exp_keys(exp, entry)
    return out, [str(x.message) for x in w]


@pytest.mark.parametrize("path", EXP_FILES, ids=rel)
def test_key_audit_warns_on_the_jax_keys(path):
    """For each entry, the ignored and unknown keys and the warning are
    the JAX package's, on the file as shipped and with keys added (an
    unknown one, a consumed one of another entry, a nerf key nothing
    reads, an empty block)."""
    exp = jloading.load_yaml(path)
    extra = dict(exp, bogus={"k": 1}, empty={}, optimizer={
        **exp["optimizer"], "lr": 1e-4}, nerf={**exp.get("nerf", {}),
                                              "scan_fit_max_images": 4})
    for e in (exp, extra):
        for entry in ("joint", "pretrain", "finetune"):
            assert _audit(taudit, e, entry) == _audit(jaudit, e, entry)
    assert _audit(taudit, extra, "joint")[0][1]  # something was unknown
    assert taudit._COMMON_CONSUMED == jaudit._COMMON_CONSUMED
    assert taudit._ENTRY_CONSUMED == jaudit._ENTRY_CONSUMED
    assert set(taudit._IGNORED) == set(jaudit._IGNORED)
    assert _same(tflatten(extra), jflatten(extra))


def _render_fields(ours, theirs):
    """Every field of the port's RenderConfig as the JAX config has it;
    None where JAX's is None."""
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(ours, f) == getattr(theirs, f), f


RENDERER_BLOCKS = {
    "no_block": None,
    "shipped": {"num_steps": 24, "upsample_steps": 8,
                "proposal_placement": True},
    "test_predict_quoted_unknown": {
        "num_steps": "48", "upsample_steps": 16, "test_num_steps": 16,
        "test_early_stop": True, "test_stage1_steps": "6",
        "predict_num_steps": 8, "predict_refine_fraction": "0.125",
        "not_a_field": 3, "test_also_not": 1},
    "jax_only_keys": {"test_packed_dtype": "bf16", "remat": False,
                      "probe_placement": False, "num_probe": 8,
                      "packed_max_entries": 0,
                      "train_packed_max_entries": 0},
    "predict_only": {"predict_num_steps": 12, "min_near": "0.05"},
}


def _exp_with(block):
    exp = {"model": {"num_classes": 40}}
    if block is not None:
        exp["renderer"] = dict(block)
    return exp


def _render_cfgs(mod, exp):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = mod.render_cfgs_from_exp(exp)
    return out, [str(x.message) for x in w]


@pytest.mark.parametrize("exp", [*JOINT_FILES, *RENDERER_BLOCKS],
                         ids=lambda p: rel(p) if os.sep in p else p)
def test_render_and_nerf_configs_match_jax(exp):
    """render_cfgs_from_exp's train / test / predict configs field by field
    and its warnings, and nerf_model_from_exp's model fields, against the
    JAX package's, on every joint and multi-step config and on renderer
    blocks with test_ / predict_ keys, quoted numbers, unknown keys and the
    keys only JAX's RenderConfig has."""
    exp = (jloading.load_yaml(exp) if os.sep in exp
           else _exp_with(RENDERER_BLOCKS[exp]))
    ours, warned = _render_cfgs(tloop, exp)
    theirs, jwarned = _render_cfgs(jloop, exp)
    assert warned == jwarned
    for a, b in zip(ours, theirs):
        _render_fields(a, b)
    jm = jloop.nerf_model_from_exp(exp, 40)
    tm = tloop.nerf_model_from_exp(exp, 40, device="cpu")
    for f in ("bound", "num_semantic_classes", "n_levels", "n_features",
              "log2_hashmap_size", "stochastic_table_grad",
              "stochastic_fwd"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.encoder.stochastic_grad == jm.stochastic_table_grad


@pytest.mark.parametrize("key", ["probe_placement", "test_probe_placement",
                                 "predict_probe_placement"])
def test_render_config_refuses_probe_placement(key):
    """probe_placement: true raised NotImplementedError until probe
    placement was ported; it is now a field like any other: the train /
    test / predict configs with it (and num_probe beside it) set or unset
    are JAX's, field by field, with its warnings."""
    prefix = key[:-len("probe_placement")]
    for on in (True, False):
        exp = _exp_with({key: on, prefix + "num_probe": 8})
        ours, warned = _render_cfgs(tloop, exp)
        theirs, jwarned = _render_cfgs(jloop, exp)
        assert warned == jwarned
        for a, b in zip(ours, theirs):
            _render_fields(a, b)
        cfg = ours[("", "test_", "predict_").index(prefix)]
        assert (cfg.probe_placement, cfg.num_probe) == (on, 8)


@pytest.mark.parametrize("nerf", [{"stochastic_fwd": "face"},
                                  {"stochastic_fwd": True, "bound": "2",
                                   "n_levels": 4, "log2_hashmap_size": 12,
                                   "stochastic_table_grad": False},
                                  {"stochastic_fwd": "fast"}])
def test_nerf_model_from_exp_blocks(nerf):
    """The nerf: block's keys as JAX reads them; an unknown stochastic_fwd
    raises on both sides."""
    exp = {"nerf": nerf}
    if nerf["stochastic_fwd"] == "fast":
        for call in (lambda: jloop.nerf_model_from_exp(exp, 6),
                     lambda: tloop.nerf_model_from_exp(exp, 6,
                                                       device="cpu")):
            with pytest.raises(ValueError, match="stochastic_fwd"):
                call()
        return
    jm = jloop.nerf_model_from_exp(exp, 6)
    tm = tloop.nerf_model_from_exp(exp, 6, device="cpu")
    for f in ("bound", "n_levels", "n_features", "log2_hashmap_size",
              "stochastic_table_grad", "stochastic_fwd"):
        assert getattr(tm, f) == getattr(jm, f), f
