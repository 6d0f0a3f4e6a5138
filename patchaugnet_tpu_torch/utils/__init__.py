"""Host utilities of the CLIs: logging and metrics, a running-average
meter, timestamp formatting (port of ``patchaugnet_tpu/utils``'s
``logging_util``, ``meters`` and ``timestamps``)."""
from .logging_util import MetricsWriter, get_logger
from .meters import AverageMeter
from .timestamps import timestamp2str

__all__ = ["get_logger", "MetricsWriter", "AverageMeter", "timestamp2str"]
