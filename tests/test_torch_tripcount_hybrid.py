"""The dry run's trip-count rule on the hybrid family (zamba2-7b): its
Mamba2 groups run through ``repro_torch.models.scan.loop``, and every
group calls the one attention block that they share, so the shared
leaf's gradient is summed over the groups.  Held, as in
``test_torch_tripcount.py``, to the unrolled trace on a ``.reduced()``
config: global FLOPs and bytes and the collective bytes a device, by
kind and by op, exactly, the predicted peak within 12a's 5 %.  A file of
its own, so that the two files' traces run on two workers."""
import os
import sys

import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_tripcount import (  # noqa: E402
    check_the_rule_equals_the_unrolled_trace, trace_cases)

# (arch, shape, global batch, seq, layers, microbatches, fake mesh of the
# 4 ranks): 4 groups of (2 Mamba2 layers, the shared attention block), 4
# microbatches
CASES = {"zamba2_train": ("zamba2-7b", "train_4k", 4, 32, 8, 4, "2x2")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trace_cases(CASES, tmp_path_factory.mktemp("tripcount_hybrid"))


@pytest.mark.parametrize("case", list(CASES))
def test_the_rule_equals_the_unrolled_trace(runs, case):
    check_the_rule_equals_the_unrolled_trace(runs[case])
