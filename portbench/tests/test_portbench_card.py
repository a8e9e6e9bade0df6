"""On the card: one short run of a cell through the command, as the
check runs it. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ctr-train-deviceplan", "--seed", "2147483747", "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
