"""Configuration (counterpart of `bsms_gnn_tpu/config.py`): the dataclass
groups, composed from the YAML group files under
`bsms_gnn_tpu_torch/configs/` (copies of the JAX package's) by
`load_config` with `key=value` overrides, and the inflating-font,
flag and cylinder-flow presets (`inflating_font_config`,
`flag_simple_config`, `cylinder_flow_config`).

`ModelConfig.aggregation` picks one of the JAX package's methods: `"ell"`
(its default: ELL gathers and sums as plain PyTorch, no kernel, on any
hierarchy), `"segment"` (its parity oracle: row selections and
`index_add`), `"fused"` (the fused edge-phase kernels: the windowed ones
on windowed layouts with at most one world-space stream, the
streamed-input ones on unwindowed layouts and for other world-space
streams) or `"pallas"` (any layout: gathers, the edge MLP as plain
matmuls, then the fused aggregation + node-phase kernel). `"fusedK"` (2 ≤
K ≤ 8) is `"fused"` with K chunks per step on the densest windowed levels
(the K-way interleaved kernel 14, `ops/kernels/fused_gmp_k.py`);
`"fused1"` is `"fused"`. The presets below pin the kernel methods.

The group files are read by a small reader of the YAML subset they use
(`parse_yaml`), so loading a config needs no PyYAML. The root key
`device` is the port's own: "" is the CUDA card, "cpu" the plain PyTorch
versions on the CPU (the JAX package picks its platform by
`JAX_PLATFORMS`)."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Tuple

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

# The widest chunk interleave `"fusedK"` takes.
MAX_INTERLEAVE = 8


def split_interleave(method: str) -> Tuple[str, int]:
    """(base method, K) of an aggregation method: `"fusedK"` → ("fused",
    K), every other method → (method, 1). K must lie in [1, 8] (JAX's
    `_split_interleave` takes any K); another digit suffix raises."""
    if method.startswith("fused") and method[5:].isdigit():
        k = int(method[5:])
        if not 1 <= k <= MAX_INTERLEAVE:
            raise ValueError(f"aggregation {method!r}: K must lie in "
                             f"[1, {MAX_INTERLEAVE}]")
        return "fused", k
    return method, 1


@dataclass
class DatasetConfig:
    """Dataset group (`configs/datasets/*.yaml`)."""

    name: str = "airfoil"
    root: str = "/data/converted/"
    tf_dataset_dir: str = "/data/"
    field_names: List[str] = field(
        default_factory=lambda: ["node_type", "cells", "mesh_pos", "density",
                                 "velocity"])
    output_field_names: List[str] = field(
        default_factory=lambda: ["velocity", "density"])
    mesh_type: str = "tri"
    unet_depth: int = 7
    # False: every trajectory has its own mesh (variable-mesh datasets),
    # padded to its size group's buckets.
    consist_mesh: bool = True
    space_dim: int = 2
    # Training noise: per-channel σ on the output fields, and the share
    # (1 − γ) of it the target absorbs.
    noise_level: List[float] = field(
        default_factory=lambda: [10.0, 10.0, 0.01])
    noise_gamma: float = 1.0
    # Read by no code of either package (the bucket plan sizes the pads).
    node_bucket: int = 0
    edge_bucket: int = 0
    # Node pads round up to this multiple (and to 128, and to window / 2).
    pad_multiple: int = 128
    # Edge slots per chunk of the block-aligned layouts.
    edge_block: int = 128
    # Variable-mesh datasets: the number of size groups, by level-0 nodes.
    size_buckets: int = 1
    # Source-window rows of the windowed layouts: > 0 Morton-reorders each
    # trajectory's mesh at ingest; 0 = unwindowed.
    window: int = 0


@dataclass
class ModelConfig:
    """Model group (`configs/model/*.yaml`)."""

    # The reference YAML's mirror of the dataset's `consist_mesh`; no code
    # reads it.
    consistent_mesh: bool = True
    latent_dim: int = 128
    hidden_layer: int = 3
    unet_depth: int = 7
    out_dim: int = 3
    pos_dim: int = 2
    # Normalizer warmup steps (NOT gradient accumulation): the first
    # `accumulation_steps` train steps only accumulate normalizer statistics.
    accumulation_steps: int = 300
    # World-space edge features (Δworld, ‖Δworld‖ beside Δmesh): the first
    # `world_dim` output channels are world positions (0 = pos_dim).
    world_edges: bool = False
    world_dim: int = 0
    # "ell", "segment", "fused", "fusedK" or "pallas" (see the module
    # docstring).
    aggregation: str = "ell"
    # The `Trainer`'s compute dtype when it is given none: "float32" or
    # "bfloat16".
    compute_dtype: str = "float32"
    # Encode/decode MLP dtype: "" = the compute dtype; "float32" pins the
    # normalized I/O boundary to full precision while the processor runs in
    # the compute dtype.
    io_dtype: str = ""
    # Checkpoint each GMP block whose level has at least `remat_min_nodes`
    # padded rows per sample: its forward is replayed in the backward
    # instead of holding its activations.
    remat: bool = False
    remat_min_nodes: int = 0

    def __post_init__(self):
        split_interleave(self.aggregation)


@dataclass
class OptConfig:
    """Optimizer group (`configs/opt/default.yaml`)."""

    peak_lr: float = 1e-4
    end_lr: float = 1e-7  # unused, as in the reference
    warmup_steps: int = 20000
    decay_steps: int = 200000
    gnorm_clip: float = 1.0
    weight_decay: float = 1e-4
    # optax.MultiSteps: the mean of this many steps' gradients is applied
    # every this-many-th step.
    gradient_accumulation_steps: int = 1


@dataclass
class ParallelConfig:
    """Chips for batch (data) and edge-partitioned graph parallelism; the
    port runs on one card, so both must be 1 (`train.run_train`)."""

    data_axis: int = 1
    graph_axis: int = 1


@dataclass
class Config:
    """Root config (`configs/default.yaml`), plus `device`."""

    datasets: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    board: bool = False
    plot: bool = True
    dump_dir: str = "/tmp/bsms-res"
    project: str = "train"
    base_seed: int = 42
    dataset_workers: int = 8
    batch: int = 48
    restore_dir: str = ""
    restore_step: int = -1
    epochs: int = 20
    steps_per_epoch: int = 10000
    loss_freq: int = 1000
    save_freq: int = 10000
    plot_freq: int = 10000
    time_freq: int = 1000
    time_warm: int = 100
    # "" = the CUDA card (raises without one), "cpu" = the CPU.
    device: str = ""


# -- the YAML subset of the group files ---------------------------------------

# YAML 1.1's plain scalars, as PyYAML's safe loader resolves them. An
# exponent without a dot (`1e-4`) is a string there; here it is a float.
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?(\.[0-9_]*)?([eE][-+]?[0-9]+)?$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


class YamlSubsetError(ValueError):
    """A construct outside the subset `parse_yaml` reads."""


def _plain(text: str) -> Any:
    low = text.lower()
    if low in ("", "~", "null"):
        return None
    if low in _BOOLS and text in (low, low.title(), low.upper()):
        return _BOOLS[low]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if re.search(r"[0-9]", text) and _FLOAT.match(text) and (
            "." in text or "e" in low):
        return float(text.replace("_", ""))
    if low in (".inf", "+.inf", "-.inf"):
        return -math.inf if text.startswith("-") else math.inf
    if low == ".nan":
        return math.nan
    if text[0] in "[]{}&*!|>%@`,\"'" or ": " in text or text.startswith("- "):
        raise YamlSubsetError(f"unsupported YAML scalar {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, index past
    its closing quote)."""
    q = text[i]
    j = i + 1
    out = []
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
                     "0": "\0", "r": "\r"}
            if esc in table:
                out.append(table[esc])
                j += 2
                continue
            if esc == "u":
                out.append(chr(int(text[j + 2:j + 6], 16)))
                j += 6
                continue
            raise YamlSubsetError(f"unsupported escape in {text!r}")
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated string in {text!r}")


def _strip_comment(text: str) -> str:
    """`text` without a trailing ` # comment` outside quotes."""
    i, quote = 0, None
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def parse_value(text: str) -> Any:
    """One YAML value of the subset: a plain or quoted scalar, or a flow
    list of them (`[a, "b", 1.0]`)."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"unsupported flow list {text!r}")
        body, items, i = text[1:-1], [], 0
        while True:
            while i < len(body) and body[i] in " \t":
                i += 1
            if i >= len(body):
                break
            if body[i] in "'\"":
                value, i = _quoted(body, i)
            else:
                j = body.find(",", i)
                j = len(body) if j < 0 else j
                raw = body[i:j].strip()
                if raw.startswith(("[", "{")):
                    raise YamlSubsetError(f"nested flow list in {text!r}")
                value, i = _plain(raw), j
            items.append(value)
            while i < len(body) and body[i] in " \t":
                i += 1
            if i < len(body):
                if body[i] != ",":
                    raise YamlSubsetError(f"unsupported flow list {text!r}")
                i += 1
        return items
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise YamlSubsetError(f"text after a quoted scalar: {text!r}")
        return value
    return _plain(text)


def parse_yaml(text: str) -> dict:
    """The mapping of a YAML document written in the group files' subset:
    `key: value` lines (plain or quoted scalars, flow lists), comments,
    blank lines, and one level of nested mapping (`defaults:` followed by
    indented `key: value` lines). Anything else raises YamlSubsetError."""
    out: dict = {}
    nested: Optional[dict] = None
    indent = None
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {n}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise YamlSubsetError(f"line {n}: document markers")
        lead = len(line) - len(line.lstrip())
        m = _KEY.match(line.strip())
        if m is None:
            raise YamlSubsetError(f"line {n}: not `key: value`: {raw!r}")
        key, value = m.group(1), m.group(2)
        if lead:
            if nested is None or (indent is not None and lead != indent):
                raise YamlSubsetError(f"line {n}: unexpected indentation")
            indent = lead
            if value is None:
                raise YamlSubsetError(f"line {n}: deeper nesting")
            if key in nested:
                raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
            nested[key] = parse_value(value)
            continue
        if key in out:
            raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
        if value is None:
            nested, indent = {}, None
            out[key] = nested
        else:
            nested = None
            out[key] = parse_value(value)
    for k, v in out.items():
        if v == {}:  # `key:` with nothing under it is null, as in YAML
            out[k] = None
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read()) or {}


# -- composition ----------------------------------------------------------------


def _coerce(value: str, target: Any) -> Any:
    """Parse a CLI string override into the type of the existing value."""
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(float(value))
    if isinstance(target, float):
        return float(value)
    if isinstance(target, list):
        return parse_value(value)
    return value


def _apply_dict(cfg: Any, d: dict) -> None:
    for k, v in d.items():
        if not hasattr(cfg, k):
            raise KeyError(f"Unknown config key {k!r} for {type(cfg).__name__}")
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        else:
            if isinstance(v, str) and isinstance(cur, (int, float)) and not isinstance(cur, bool):
                v = _coerce(v, cur)
            if isinstance(v, list) and isinstance(cur, list) and cur and isinstance(cur[0], float):
                v = [float(x) for x in v]
            setattr(cfg, k, v)


def _set_dotted(cfg: Config, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, parts[-1])
    setattr(obj, parts[-1], _coerce(value, cur))


def load_config(overrides: Optional[List[str]] = None,
                config_dir: str = _CONFIG_DIR) -> Config:
    """Compose the config as the JAX package's `load_config` does:
    `default.yaml`'s `defaults:` groups, then the root keys, then the
    overrides. An override is a group swap (`datasets=cylinder_flow`,
    which also swaps `model` when `model/cylinder_flow.yaml` exists) or a
    dotted value (`opt.peak_lr=3e-4`, `batch=16`, `device=cpu`) parsed to
    the type of the value it replaces."""
    overrides = list(overrides or [])
    cfg = Config()

    default = _load_yaml(os.path.join(config_dir, "default.yaml"))
    group_choice = dict(default.pop("defaults", None) or {})

    value_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must be key=value")
        k, v = ov.split("=", 1)
        if k in group_choice and os.path.isfile(
                os.path.join(config_dir, k, v + ".yaml")):
            group_choice[k] = v
            if k == "datasets" and os.path.isfile(
                    os.path.join(config_dir, "model", v + ".yaml")):
                group_choice["model"] = v
        else:
            value_overrides.append((k, v))

    for group, choice in group_choice.items():
        path = os.path.join(config_dir, group, choice + ".yaml")
        _apply_dict(getattr(cfg, group), _load_yaml(path))

    _apply_dict(cfg, default)

    for k, v in value_overrides:
        _set_dotted(cfg, k, v)

    return cfg


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def _yaml_scalar(v: Any) -> str:
    """A scalar in a form YAML 1.1's safe loader reads back to `v`."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # YAML 1.1 floats need a dot
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"no YAML form for {type(v).__name__}")


def to_yaml(cfg: Any) -> str:
    """The config as YAML block mappings (flow lists, double-quoted
    strings), which `yaml.safe_load` reads back to `to_dict(cfg)`."""
    lines = []

    def emit(d: dict, indent: str) -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                lines.append(f"{indent}{k}:")
                emit(v, indent + "  ")
            elif isinstance(v, (list, tuple)):
                lines.append(f"{indent}{k}: [" + ", ".join(
                    _yaml_scalar(x) for x in v) + "]")
            else:
                lines.append(f"{indent}{k}: {_yaml_scalar(v)}")

    emit(to_dict(cfg), "")
    return "\n".join(lines) + "\n"


def inflating_font_config(**model_overrides) -> Config:
    """The inflating elastic surface: `configs/model/inflating_font.yaml`
    and `configs/datasets/inflating_font.yaml` of the JAX package (a closed
    3-D surface whose world positions are the output fields, world-space
    edges), on the `pallas` method, bench.py's method for it (the `fused`
    method runs world edges too: `aggregation="fused"`). `model_overrides`
    replace ModelConfig fields (bench.py's surface point sets
    unet_depth=7)."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=4,
                        out_dim=3, pos_dim=3, accumulation_steps=300,
                        world_edges=True, aggregation="pallas")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.003] * 3,
                                         noise_gamma=1.0))


def flag_simple_config(**model_overrides) -> Config:
    """The cloth flag: `configs/model/flag_simple.yaml` and
    `configs/datasets/flag_simple.yaml` of the JAX package (a 2-D mesh
    moving in 3-D world space, world positions as the output fields,
    world-space edges), on the `fused` method, the JAX package's recipe for
    world edges on a windowed, Morton-ordered layout. `model_overrides`
    replace ModelConfig fields."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=5,
                        out_dim=3, pos_dim=2, accumulation_steps=300,
                        world_edges=True, world_dim=3, aggregation="fused")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.003] * 3,
                                         noise_gamma=0.1))


def deforming_plate_config(**model_overrides) -> Config:
    """The deforming plate: `configs/model/deforming_plate.yaml` and
    `configs/datasets/deforming_plate.yaml` of the JAX package (a 3-D tetra
    mesh whose world positions are the output fields, world-space edges,
    one mesh per trajectory), on the `fused` method: kernel 13 on the
    windowed levels, their out-of-window edges on the residual sub-levels
    of the bucketed build. `model_overrides` replace ModelConfig fields."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=5,
                        out_dim=3, pos_dim=3, accumulation_steps=300,
                        world_edges=True, aggregation="fused")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(
                      name="deforming_plate", mesh_type="tetra",
                      field_names=["node_type", "cells", "mesh_pos",
                                   "world_pos"],
                      output_field_names=["world_pos"], unet_depth=5,
                      consist_mesh=False, space_dim=3,
                      noise_level=[0.003] * 3, noise_gamma=1.0))


def cylinder_flow_config(**model_overrides) -> Config:
    """Flow past a cylinder: `configs/model/cylinder_flow.yaml` and
    `configs/datasets/cylinder_flow.yaml` of the JAX package (velocity as
    the output fields, 2-D meshes, one mesh per trajectory), on the `fused`
    method. `model_overrides` replace ModelConfig fields."""
    model = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=5,
                        out_dim=2, pos_dim=2, accumulation_steps=300,
                        aggregation="fused")
    return Config(model=replace(model, **model_overrides),
                  datasets=DatasetConfig(noise_level=[0.02, 0.02],
                                         noise_gamma=1.0, consist_mesh=False))
