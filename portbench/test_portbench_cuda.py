"""On the card: each cell, cut to the test's size, runs traced and
untraced with ``correct`` true, and its control at the same size fails.
Skips without a card; on one: ``python -m pytest portbench -m cuda``."""

import pytest

from portbench import harness
from portbench.conftest import CELLS
from portbench.control import control_numbers

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_card(cell, traced, card, tiny):
    result, lines = harness.run_cell(cell, 2**31 + 99, 1.0, traced, card, tiny(cell))
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert any(k.startswith("device_idle_pct") for k in result["metrics"])
        share = [v["value"] for k, v in result["metrics"].items() if "_roofline_pct" in k]
        assert share and all(0 < s <= 100 for s in share)


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, card, tiny):
    assert control_numbers(cell, 5, card, tiny(cell))["correct"] is False
