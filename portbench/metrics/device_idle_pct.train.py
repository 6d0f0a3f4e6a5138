"""Share of the profiled slice's span covered by no kernel, copy or set."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
