"""Model FLOPs per second over the untraced window, as a share of the configuration dtype's peak."""
from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
