"""The port's copy of the MXDAG core equals the JAX package's.

``src/repro_torch/core/`` is ``src/repro/core/`` with one substitution,
``repro.core`` → ``repro_torch.core`` (imports, and the cross-references
of the docstrings), as ``repro_torch.configs`` copies ``repro.configs``.
The core's own tests run on the original; these hold the copy to it.
"""
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ORIGINAL = ROOT / "src" / "repro" / "core"
COPY = ROOT / "src" / "repro_torch" / "core"
FILES = sorted(p.name for p in ORIGINAL.glob("*.py"))


def test_the_copy_has_every_file_and_no_other():
    assert len(FILES) == 16
    assert sorted(p.name for p in COPY.glob("*.py")) == FILES


@pytest.mark.parametrize("name", FILES)
def test_copy_equals_the_original_after_the_one_substitution(name):
    want = (ORIGINAL / name).read_text().replace("repro.core",
                                                 "repro_torch.core")
    assert (COPY / name).read_text() == want


def test_the_copy_schedules_as_the_original():
    """The same Fig. 1 graph through both packages' scheduler: the same
    priorities and makespan."""
    from repro.core import MXDAGScheduler as JScheduler
    from repro.core import builders as jbuilders
    from repro_torch.core import MXDAGScheduler as TScheduler
    from repro_torch.core import builders as tbuilders
    j = JScheduler().schedule(jbuilders.fig1_jobs())
    t = TScheduler().schedule(tbuilders.fig1_jobs())
    assert t.priorities == j.priorities
    assert t.simulate().makespan == j.simulate().makespan
