"""K1 and K2's least time over their device time in the profiled slice, attributed by launch correlation."""
from portbench.readers import fps_knn_roofline_pct


def read(run):
    return fps_knn_roofline_pct(run)
