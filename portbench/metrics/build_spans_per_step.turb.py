"""Window builds a step in the traced window, counted as the program's
``sphax_torch.build`` spans (``portbench/spans.py``): measured at the fixed
cadence too, where ``builds_per_step.turb`` takes one per 2 steps."""
from portbench import spans


def read(run):
    return spans.count_per_step(run, "sphax_torch.build")
