"""The device's idle share of the traced window: 100 x (1 - busy / window),
busy being the union of the device operations in the profiler's trace."""
from benchmark.readers import idle

UNIT = "%"


def read(run):
    return idle(run)
