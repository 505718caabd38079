"""The control, at a cell's own size on the card, comes out not correct on
three seeds: the program's own int8 path (``Pipeline.quantize('w8a8')``)
for the dense cell; the reference computed in fp8 in the program's place
for the MoE cell (``control.py``)."""

import time

import harness
import pytest

CONTROLS = {'v1_t2i_b32': 'program', 'moe_lb_t2i_b64': 'reference'}


@pytest.mark.card
@pytest.mark.parametrize('cell', sorted(CONTROLS))
@pytest.mark.parametrize('seed', [9001, 9002, 9003])
def test_control_fails(card, cell, seed):
    c = harness.resolve(cell)
    res, numbers = harness.run_cell(c, seed, 5, 0, 'cuda', time.time(),
                                    control=CONTROLS[cell])
    assert not res['correct'], res['compared']
