"""The correctness check's control at a size a test run can hold: the
reference computed from fp8 operands, put in the program's place on the
same prompts and served tokens, fails the limit that the program meets
(on the chip, ``python3 -m portbench.control`` reads both at the cells'
own sizes)."""
import time

import pytest

from portbench import bench
from portbench.tests import tiny


@pytest.mark.parametrize("workload", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_fp8_control_fails_where_the_program_passes(workload, tmp_path):
    # every finished request scored: at this size fp8 rounding moves the
    # argmax at a few positions in a hundred
    root = tiny.make_tree(tmp_path, limit=1e-3,
                          mix=dict(tiny.MIX, check_requests=1000))
    cell = bench.Cell(root, bench.load(root), workload)
    run = cell.run(seed=17, seconds=1.5, trace=False, device="cpu",
                   t_start=time.perf_counter(), control=True)
    program, limit = run.compared["logit_gap"]
    assert program <= limit < run.notes["control"]["fp8"]["logit_gap"], run.notes
