"""``device_idle`` in the served cell, where it moves ``step_p90_s``: the
share of the profiled slice (steps around a chunk boundary) in which no
kernel ran, in %."""

from portbench.spec import reader

read = reader("device_idle").read
