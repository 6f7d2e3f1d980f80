"""Unified dataclass config tree with CLI overrides, the port's copy of
`ghost_tpu/core/config.py` (plain Python: the same tree, the same
coercion and the same errors).

The reference mixes three config mechanisms: per-script argparse
(reference train.py:554-603), static option classes (models/config_sr.py),
and SPADE's dynamic commandline registry (models/networks/__init__.py:15-37).
Here one nested-dataclass tree covers the framework, with `apply_overrides`
accepting `section.field=value` strings (the CLI escape hatch),
`add_config_flag` adding the repeatable `--set KEY=VALUE` flag to a
parser and `config_from_args` reading it back.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, get_type_hints


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "unet"
    num_blocks: int = 2
    c_id: int = 512
    width: float = 1.0
    arcface_depth: str = "iresnet100"


@dataclasses.dataclass
class InferenceConfig:
    crop_size: int = 224
    similarity_th: float = 0.15
    det_thresh: float = 0.6
    det_size: int = 640
    max_faces: int = 8
    chunk_size: int = 32
    batch_size: int = 40
    use_sr: bool = False


@dataclasses.dataclass
class TrainConfig:
    lr_g: float = 4e-4
    lr_d: float = 4e-4
    b1: float = 0.0
    b2: float = 0.999
    weight_decay: float = 1e-4
    batch_size: int = 16
    d_interval: int = 10
    mode: str = "canonical"
    weight_adv: float = 1.0
    weight_attr: float = 10.0
    weight_id: float = 15.0
    weight_rec: float = 10.0
    weight_eyes: float = 0.0
    eye_detector_loss: bool = False
    save_interval: int = 2500
    show_step: int = 250


@dataclasses.dataclass
class MeshConfig:
    data: int = -1  # -1: all devices
    model: int = 1


@dataclasses.dataclass
class GhostConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    bf16: bool = True
    seed: int = 0


def _coerce(value: str, ty: type) -> Any:
    if ty is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return ty(value)


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply `section.field=value` strings; returns a new config."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        path, value = item.split("=", 1)
        parts = path.split(".")
        # walk to the parent dataclass, rebuild immutably bottom-up
        def rebuild(node, parts):
            field = parts[0]
            if not hasattr(node, field):
                raise AttributeError(f"no config field {field!r} on {type(node).__name__}")
            if len(parts) == 1:
                hints = get_type_hints(type(node))
                new_val = _coerce(value, hints[field])
                return dataclasses.replace(node, **{field: new_val})
            child = rebuild(getattr(node, field), parts[1:])
            return dataclasses.replace(node, **{field: child})

        cfg = rebuild(cfg, parts)
    return cfg


def add_config_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. --set train.lr_g=1e-4",
    )


def config_from_args(args: argparse.Namespace) -> GhostConfig:
    return apply_overrides(GhostConfig(), getattr(args, "set", []) or [])
