"""The comparison on the card: the viewer's kernels (B1-B4) against the
plain reference on a small view, and the bfloat16 control not correct.
Run on the card with `python -m pytest benchmark/tests -m card`."""

import pytest
import torch

from gbench.cell import compare, run_cell
from test_bench_reference import SEED, small, verdict


@pytest.mark.card
@pytest.mark.parametrize("cell", [("deferred_hdr", "orbit_1080p"),
                                  ("forward_pcf", "walk_1080p")],
                         ids=["deferred_hdr", "forward_pcf"])
def test_card_sound_and_control(card, cell):
    cfg, tr = small(*cell)
    tr.update(width=640, height=352)
    res = run_cell(cfg, tr, SEED, 1.0, False, "cuda", log=lambda *a: None)
    refs: dict = {}
    sound = compare(res, cfg, "cuda", log=lambda *a: None, refs=refs)
    assert verdict(cfg, sound["numbers"]), sound["numbers"]
    ctl = compare(res, cfg, "cuda", control=True, log=lambda *a: None,
                  refs=refs)
    assert not verdict(cfg, ctl["numbers"]), ctl["numbers"]
    torch.cuda.synchronize()
