"""On the card: one short run of each cell holds to the reference.  Marked
``cuda``; without a card each skips (decided in the ``card`` fixture).  On
the card: ``python3 -m pytest -m cuda portbench/tests/test_card.py``."""

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["headline_steady", "headline_common"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    line, _checks, _info = harness.run_cell(cell, 2**31 + 99, 3.0, False,
                                            device=card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["setup_s"]["value"] > 0
