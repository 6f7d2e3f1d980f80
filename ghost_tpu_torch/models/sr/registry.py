"""SR network registry, mirroring `ghost_tpu/models/sr/registry.py`: the
reference resolves generators, discriminators and encoders by lowercase
class name at run time ('lipspade' -> LIPSPADEGenerator; reference
models/networks/__init__.py:15-63, models/config_sr.py:21). Here, as in
JAX, explicit tables with the same names; an unknown name raises the
JAX package's KeyError word for word."""

from __future__ import annotations

from typing import Callable, Dict

from ghost_tpu_torch.models.discriminator import (MultiscaleDiscriminator,
                                                  NLayerDiscriminator)
from ghost_tpu_torch.models.sr.encoder import ConvEncoder
from ghost_tpu_torch.models.sr.generator import (HiFaceGANGenerator,
                                                 LIPSPADEGenerator,
                                                 SPADEGenerator)

GENERATORS: Dict[str, Callable] = {
    "spade": SPADEGenerator,
    "lipspade": LIPSPADEGenerator,
    "hifacegan": HiFaceGANGenerator,
}

DISCRIMINATORS: Dict[str, Callable] = {
    "multiscale": MultiscaleDiscriminator,
    "nlayer": NLayerDiscriminator,
}

ENCODERS: Dict[str, Callable] = {"conv": ConvEncoder}


def define_g(name: str, **kwargs):
    try:
        return GENERATORS[name.lower()](**kwargs)
    except KeyError:
        raise KeyError(
            f"unknown SR generator {name!r}; options: {sorted(GENERATORS)}"
        ) from None


def define_d(name: str, **kwargs):
    try:
        return DISCRIMINATORS[name.lower()](**kwargs)
    except KeyError:
        raise KeyError(
            f"unknown SR discriminator {name!r}; options: {sorted(DISCRIMINATORS)}"
        ) from None


def define_e(name: str, **kwargs):
    try:
        return ENCODERS[name.lower()](**kwargs)
    except KeyError:
        raise KeyError(
            f"unknown SR encoder {name!r}; options: {sorted(ENCODERS)}"
        ) from None
