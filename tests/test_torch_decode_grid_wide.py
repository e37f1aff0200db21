"""Decode on (1,4) and (2,2) grids of four gloo ranks with JAX's cache
layout: the second half of ``tests/test_torch_decode_grid.py`` (split so
that each file's ranks and JAX steps take one worker about a minute).

chatglm3-6b on (1,4) (2 KV heads: attention replicated over the model
group, its cache's T split four ways) and deepseek-7b on (1,4) (one head
a rank); olmoe-1b-7b and jamba-v0.1-52b on (2,2) (B over "data", T over
"model"), and jamba with a batch of 1 (B whole, T over all four ranks).
Every rank's prefill and decode-step logits equal the one-process port's
and JAX's sharded decode, to 1e-4 of max|·|; its blocks sit where JAX's
index maps put them; its collectives are ``step_log``'s.
"""
import pytest

from test_torch_decode_grid import (CELLS, build, check_jax, check_logs,
                                    check_one_process)

WIDE = [c for c in CELLS if c[2] in ((1, 4), (2, 2))]
TAGS = [c[0] for c in WIDE]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return build(tmp_path_factory.mktemp("decode_grid_wide"), WIDE)


@pytest.mark.parametrize("tag", TAGS)
def test_grid_decode_equals_one_process(served, tag):
    """``check_one_process``."""
    check_one_process(served, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_grid_decode_equals_jax_on_its_mesh(served, tag):
    """``check_jax``."""
    check_jax(served, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_grid_decode_logs_its_collectives(served, tag):
    """``check_logs``."""
    check_logs(served, tag)
