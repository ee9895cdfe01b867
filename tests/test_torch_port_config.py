"""The port's config composition against the JAX package's: its YAML
reader against `yaml.safe_load` on every group file of both packages,
`load_config` field for field over override lists (the defaults, every
`datasets=` group, dotted, list and bool overrides), `to_yaml` read back
by PyYAML, the unknown keys' errors, and the subset reader's refusals."""

import dataclasses
import glob
import os

import pytest
import yaml

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu import config as jax_config
from bsms_gnn_tpu_torch import config as port_config
from bsms_gnn_tpu_torch.config import (
    YamlSubsetError,
    load_config,
    parse_value,
    parse_yaml,
    to_dict,
    to_yaml,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_FILES = sorted(
    glob.glob(os.path.join(REPO, "bsms_gnn_tpu", "configs", "**", "*.yaml"),
              recursive=True)
    + glob.glob(os.path.join(REPO, "bsms_gnn_tpu_torch", "configs", "**",
                             "*.yaml"), recursive=True))
DATASETS = sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(
    os.path.join(REPO, "bsms_gnn_tpu", "configs", "datasets", "*.yaml")))
OVERRIDES = (
    [],
    *([f"datasets={d}"] for d in DATASETS),
    ["datasets=cylinder_flow", "opt.peak_lr=3e-4", "batch=16",
     "model.aggregation=fused"],
    ["model.world_edges=true", "plot=false", "datasets.consist_mesh=no",
     "board=1", "model.remat=off"],
    ["datasets.noise_level=[0.5, 0.25, 1]", "datasets.field_names=[a, 'b']",
     "datasets.window=256", "datasets.edge_block=512"],
    ["datasets=synthetic_airfoil", "model.unet_depth=2",
     "datasets.unet_depth=2", "opt.gradient_accumulation_steps=2",
     "restore_dir=/x/y", "restore_step=4", "epochs=1.0"],
    ["datasets=flag_simple", "model=airfoil", "opt=default",
     "dump_dir=/tmp/z", "model.compute_dtype=bfloat16"],
)


def _is_dotless_exponent(v):
    return isinstance(v, str) and v.replace("-", "").replace("e", "").isdigit()


@pytest.mark.parametrize("path", GROUP_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_reader_equals_safe_load(path):
    """Every value equal to PyYAML's, but an exponent without a dot
    (`1e-4`), a string to YAML 1.1 and a float here."""
    with open(path) as f:
        text = f.read()
    got, want = parse_yaml(text), yaml.safe_load(text)
    assert set(got) == set(want)
    for k, w in want.items():
        if _is_dotless_exponent(w):
            assert got[k] == float(w), k
        else:
            assert got[k] == w and type(got[k]) is type(w), k


def test_group_files_are_the_jax_packages():
    for path in GROUP_FILES:
        if "bsms_gnn_tpu_torch" not in path:
            continue
        jax_path = path.replace("bsms_gnn_tpu_torch", "bsms_gnn_tpu")
        with open(path) as a, open(jax_path) as b:
            assert a.read() == b.read(), path
    assert len([p for p in GROUP_FILES if "bsms_gnn_tpu_torch" in p]) == 15


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=lambda o: " ".join(o) or "defaults")
def test_load_config_equals_jax(overrides):
    got = to_dict(load_config(overrides))
    want = jax_config.to_dict(jax_config.load_config(overrides))
    assert got.pop("device") == ""
    assert got == want
    for group in ("datasets", "model", "opt", "parallel"):
        for k, v in want[group].items():
            assert type(got[group][k]) is type(v), f"{group}.{k}"


def test_device_override():
    assert load_config(["device=cpu"]).device == "cpu"


@pytest.mark.parametrize("overrides", OVERRIDES[:3] + OVERRIDES[-3:],
                         ids=lambda o: " ".join(o) or "defaults")
def test_to_yaml_reads_back_as_jax_to_dict(overrides):
    cfg = load_config(overrides)
    back = yaml.safe_load(to_yaml(cfg))
    assert back.pop("device") == ""
    assert back == jax_config.to_dict(jax_config.load_config(overrides))


def test_unknown_keys_raise_as_jax(tmp_path):
    """An unknown key in a group file raises KeyError in both packages; an
    unknown dotted override raises the same error in both."""
    cfg_dir = tmp_path / "configs"
    for sub in ("datasets", "model", "opt"):
        (cfg_dir / sub).mkdir(parents=True)
    src = os.path.join(REPO, "bsms_gnn_tpu_torch", "configs")
    for path in glob.glob(os.path.join(src, "**", "*.yaml"), recursive=True):
        rel = os.path.relpath(path, src)
        with open(path) as f:
            (cfg_dir / rel).write_text(f.read())
    (cfg_dir / "model" / "bad.yaml").write_text("latent_dim: 8\nnot_a_key: 1\n")
    for load in (load_config, jax_config.load_config):
        with pytest.raises(KeyError, match="not_a_key"):
            load(["model=bad"], config_dir=str(cfg_dir))
    for bad in (["model.not_a_key=1"], ["nonexistent.knob=1"]):
        errors = []
        for load in (load_config, jax_config.load_config):
            with pytest.raises(Exception) as e:
                load(bad)
            errors.append(type(e.value))
        assert errors[0] is errors[1], bad
    for load in (load_config, jax_config.load_config):
        with pytest.raises(ValueError, match="key=value"):
            load(["batch"])


@pytest.mark.parametrize("text", [
    "a:\n  b:\n    c: 1\n",  # deeper nesting
    "a:\n  - 1\n",  # block list
    "a: [[1, 2]]\n",  # nested flow list
    "a: {b: 1}\n",  # flow mapping
    "a: &x 1\n",  # anchor
    "a: |\n  text\n",  # block scalar
    "- 1\n",  # a document that is not a mapping
    "a: 1\na: 2\n",  # duplicate key
    "a: 'open\n",  # unterminated quote
])
def test_reader_refuses_other_yaml(text):
    with pytest.raises(YamlSubsetError):
        parse_yaml(text)


def test_reader_scalars():
    cases = {"true": True, "False": False, "yes": True, "~": None,
             "12": 12, "-3": -3, "1.5": 1.5, "1.0e-07": 1e-7, "'a # b'": "a # b",
             '"q\\"x"': 'q"x', "/data/": "/data/", "[]": [],
             "[1, 'a, b', c]": [1, "a, b", "c"]}
    for text, want in cases.items():
        got = parse_value(text)
        assert got == want and type(got) is type(want), text
        assert yaml.safe_load(text) == want, text
    assert parse_yaml("a: 1 # note\nb: 'x#y'\n") == {"a": 1, "b": "x#y"}


def test_config_fields_are_jax_plus_device():
    for name in ("DatasetConfig", "ModelConfig", "OptConfig",
                 "ParallelConfig", "Config"):
        got = [f.name for f in dataclasses.fields(getattr(port_config, name))]
        want = [f.name for f in dataclasses.fields(getattr(jax_config, name))]
        assert [n for n in got if n != "device"] == want, name
