"""The measurement scripts' source edits: every (old, new) edit of
k1_ablate.py's and k2_ablate.py's variants finds its text exactly once in
the current kernel source (as `build.build_variants` requires on the card)
and makes a copy that differs from the source. An edit that no longer
applies would otherwise show only on the card."""

import runpy
from pathlib import Path

import pytest

from df3d_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]
# each script's variant tables that edit the current source (the
# PARENT_* tables edit an earlier commit's, given on the command line)
TABLES = {"k1_ablate.py": ("sparse_conv.cu", ("VARIANTS", "BF16_VARIANTS")),
          "k2_ablate.py": ("msda.cu", ("VARIANTS", "BWD_VARIANTS"))}


def _cases():
    for script, (source, tables) in TABLES.items():
        module = runpy.run_path(str(ROOT / script))
        for table in tables:
            for name, edits in module[table].items():
                yield pytest.param(source, name, edits,
                                   id=f"{script}:{table}:{name}")


@pytest.mark.parametrize("source, name, edits", list(_cases()))
def test_edit_applies_once(source, name, edits):
    text = (build.CSRC / source).read_text()
    for old, new in edits:
        assert text.count(old) == 1, f"{name}: {old!r}"
        assert old != new
    edited = build.apply_edits(text, edits, name)
    assert (edited == text) == (not edits)
