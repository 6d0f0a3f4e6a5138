"""Host utilities of the CLIs: logging and metrics, a running-average
meter, timestamp formatting, parameter counts, FLOPs and device timing
(port of ``patchaugnet_tpu/utils``'s ``logging_util``, ``meters``,
``timestamps`` and ``profiling``)."""
from .logging_util import MetricsWriter, get_logger
from .meters import AverageMeter
from .profiling import DeviceTimer, flops, parameter_count
from .timestamps import timestamp2str

__all__ = ["get_logger", "MetricsWriter", "AverageMeter", "timestamp2str", "DeviceTimer", "flops",
           "parameter_count"]
