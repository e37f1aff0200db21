"""The port's "model" axis on a (2,2) grid of four gloo ranks, with
``fsdp``: the second half of ``tests/test_torch_model_axis.py`` (split so
that each file's ranks and JAX steps take one worker about a minute).

Each arch's step (the MoE archs with both combines) equals the
one-process step at two microbatches (one a data row) and JAX's step on
an Auto (2,2) mesh of host devices, to 1e-4 of max|·|; with int8
moments and fp8 compression too; its checkpoints carry JAX's layout
both ways.
"""
import pytest

from test_torch_model_axis import (
    CELLS_2x2, MOE, build_steps, check_checkpoints, check_combines,
    check_extras, check_jax, check_one_process, check_serving, ckpt_tags,
    extras_tags, jax_tags, step_tags)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return build_steps(tmp_path_factory.mktemp("model_axis_2x2"), CELLS_2x2)


@pytest.mark.parametrize("tag", step_tags(CELLS_2x2))
def test_grid_step_equals_one_process(steps, tag):
    """``check_one_process``."""
    check_one_process(steps, tag)


@pytest.mark.parametrize("tag", step_tags(CELLS_2x2))
def test_grid_serving_equals_one_process(steps, tag):
    """``check_serving``."""
    check_serving(steps, tag)


@pytest.mark.parametrize("tag", jax_tags(CELLS_2x2))
def test_grid_step_equals_jax_on_its_mesh(steps, tag):
    """``check_jax``."""
    check_jax(steps, tag)


@pytest.mark.parametrize("arch", MOE)
def test_the_two_combines_agree(steps, arch):
    """``check_combines``."""
    check_combines(steps, arch, "2x2")


@pytest.mark.parametrize("tag", extras_tags(CELLS_2x2))
def test_int8_moments_and_fp8_compression_on_a_grid(steps, tag):
    """``check_extras``."""
    check_extras(steps, tag)


@pytest.mark.parametrize("tag", ckpt_tags(CELLS_2x2))
def test_checkpoints_carry_jax_s_layout_both_ways(steps, tag):
    """``check_checkpoints``."""
    check_checkpoints(steps, tag)
