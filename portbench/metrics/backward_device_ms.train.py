"""Device milliseconds from the first gradient at a model output to the optimizer's step, mean per step."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "backward_device_s")
