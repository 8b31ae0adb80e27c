"""``idle_share.rungs``'s reading, in the timestep limiter's cell."""
from portbench import spec

read = spec.reader("idle_share.rungs")
