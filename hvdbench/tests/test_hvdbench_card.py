"""The harness on the card at a tiny size: a traced run of the tiny GPT
cell reads every per-layer metric from a real device trace.  Skips
without a card; on the card:

    python -m pytest -p no:cacheprovider hvdbench/tests -m cuda -q
"""

import pytest
import torch

from hvdbench import run, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def test_a_traced_run_on_the_card(tree, card):
    cell = spec.Cell("gpt_tiny.cpu", root=tree)
    line, ranks, _ = run.run_cell(cell, 2 ** 31 + 3, 1.0, True,
                                  device=card)
    assert line["device"]["busy_s"] > 0
    assert line["device"]["busy_s"] <= line["device"]["window_s"]
    assert ranks[0]["trace"]["kernel_s"]
    assert line["breakdown"]["device_ops"]
