"""The controls of `correct` fail their cells' limits: the reference in
bfloat16 put in the aligner's place, and the short-read reference with
the proper-pair guarantee broken.  On the CPU at a small size; the `cuda`
case runs them at the cells' own sizes on three seeds."""

import pytest
import torch

from cardbench import control, run

from .small import small_cell

SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.mark.parametrize("cell", ["chr21_ont_deep", "yeast_ont_align"])
def test_align_control_fails_small(cell):
    spec = small_cell(cell)
    spec["config"]["reads_per_call"] = 24
    out = control.align_control(spec, 11, torch.device("cpu"))
    assert not out["correct"], out
    assert out["score_deficit_pct"] > spec["limits"]["score_deficit_pct"]
    assert out["misplaced_pct"] > spec["limits"]["misplaced_pct"]


def test_align_control_machinery_in_int32_is_correct():
    """The same reference in the configuration's own precision, written as
    SAM and judged by the same code, serves every read at its best."""
    spec = small_cell("chr21_ont_deep")
    spec["config"]["reads_per_call"] = 24
    out = control.align_control(spec, 11, torch.device("cpu"), torch.int32)
    assert out["correct"], out
    assert out["score_deficit_pct"] == 0.0 and out["misplaced_pct"] == 0.0
    assert out["introns_missed_pct"] == 0.0 and out["reads"] > 0


def test_sr_control_fails_small():
    spec = small_cell("chr21_sr_count")
    out = control.sr_control(spec, 11, torch.device("cpu"))
    assert out["count_diffs"] > spec["limits"]["count_diffs"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chr21_ont_deep", "yeast_ont_align",
                                  "chr21_sr_count"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a card: the controls run at the cells' sizes")
    spec = run.load_cell(cell)
    fn = (control.align_control if spec["traffic"]["entry"] == "align"
          else control.sr_control)
    for seed in SEEDS:
        out = fn(spec, seed, torch.device("cuda"))
        assert any(out[k] > lim for k, lim in spec["limits"].items()), out
