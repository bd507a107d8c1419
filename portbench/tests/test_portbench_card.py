"""On the card, at each cell's own size and load (a short window): the sound
program's served images pass the output check and the control's fail it.
Marked `cuda`; the `card` fixture skips where torch sees no CUDA device.

    python3 -m pytest -q portbench/tests/test_portbench_card.py
"""
import time

import pytest

from portbench.harness import cell
from portbench.harness.spec import Spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship.grid50", "v2.online", "flagship.online"])
def test_control_fails_where_the_program_passes(card, name):
    res = cell.run(Spec(), name, 2**31 + 99, 3.0, False, card, time.perf_counter(),
                   metric_names=[], control=True)
    v = res["verdict"]
    assert v["correct"], v["numbers"]
    assert not v["control"]["correct"], v["control"]["numbers"]
