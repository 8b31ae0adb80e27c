"""Host ms a step inside the program's spans: the union of the top-level spans'
intervals (``portbench/spans.py``), the host's busy time, to set beside the
device's busy ms a step."""
from portbench import spans


def read(run):
    return spans.host_ms_per_tick(run)
