"""``active_frac.rungs``'s reading, in the timestep limiter's cell."""
from portbench import spec

read = spec.reader("active_frac.rungs")
