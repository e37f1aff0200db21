"""The port's config copies equal the JAX package's, field for field."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.models.model import derive_segments as jderive
from repro_torch import configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.models.model import derive_segments as tderive

ARCHS = sorted(jconfigs.ARCHS)


def test_same_arch_names():
    assert sorted(tconfigs.ARCHS) == ARCHS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_segments_equal(arch, smoke):
    get_j = jconfigs.get_smoke if smoke else jconfigs.get
    get_t = tconfigs.get_smoke if smoke else tconfigs.get
    cj, ct = get_j(arch), get_t(arch)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.param_counts() == cj.param_counts()
    segs_j = [dataclasses.asdict(s) for s in jderive(cj)]
    segs_t = [dataclasses.asdict(s) for s in tderive(ct)]
    assert segs_t == segs_j


def test_run_config_fields_match_but_attn_impl_names_the_port_paths():
    tj = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    tt = {f.name: f.default for f in dataclasses.fields(TRunConfig)}
    assert tj.keys() == tt.keys()
    assert {k: v for k, v in tt.items() if k != "attn_impl"} == \
        {k: v for k, v in tj.items() if k != "attn_impl"}
    assert tt["attn_impl"] == "kernel"
