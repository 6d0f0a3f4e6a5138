"""Host milliseconds of a batch from its copy to its descriptors on the host, 95th percentile over the window's untraced batches."""
from portbench.readers import p95_ms


def read(run):
    return p95_ms(run, "batch_s")
