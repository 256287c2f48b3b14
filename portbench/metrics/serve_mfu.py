"""Model FLOPs of the prompts prefilled and the tokens decoded in the
window (active parameters only: the family's ``model_flops``) over the
window's seconds times the H100's bf16 peak, in %."""
from portbench.drivers.serve_closed_loop import window_flops
from portbench.work import PEAK_BF16_FLOPS

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model", "tokens_per_s"


def read(run):
    f = window_flops(run)
    return 100 * f / (run.seconds * PEAK_BF16_FLOPS) if f else None
