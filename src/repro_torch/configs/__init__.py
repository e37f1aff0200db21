"""Config registry: ``get(name)`` / ``get_smoke(name)`` / ``ARCHS``."""
from repro_torch.configs.base import (
    ArchConfig, RunConfig, ShapeConfig, SHAPES, applicable_shapes,
)

from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.deepseek_7b import CONFIG as _ds7b
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.deepseek_coder_33b import CONFIG as _dscoder
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _jamba, _olmoe, _dsv3, _ds7b, _nemotron,
    _chatglm3, _dscoder, _whisper, _mamba2, _internvl2,
]}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return get(name).reduced()


__all__ = ["ArchConfig", "RunConfig", "ShapeConfig", "SHAPES",
           "applicable_shapes", "ARCHS", "get", "get_smoke"]
