"""Host milliseconds from the call of the program's entry to its return (before any read), mean over the window's calls."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "enqueue_s")
