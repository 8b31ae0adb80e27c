"""``host_ms_per_tick.rungs``'s reading, in the timestep limiter's cell."""
from portbench import spec

read = spec.reader("host_ms_per_tick.rungs")
