"""Runtime substrate: logging, timers, statistics, registries, options.

JAX replacement for lucille's `src/base` layer (memory/containers/
threads/atomics/queues/MPI — SURVEY.md section 2.1).  Here the substrate
is the Python host process + JAX runtime, so the pieces that survive are the
*observability* and *configuration* services; threads/queues/atomics are
replaced by static sharding and XLA collectives (see lucille_tpu.parallel).
"""

from lucille_tpu.base.log import (
    LOG_DEBUG,
    LOG_INFO,
    LOG_WARN,
    LOG_ERROR,
    LOG_FATAL,
    get_logger,
    log,
    log_once,
    set_debug,
)
from lucille_tpu.base.timer import Timer, get_timer
from lucille_tpu.base.stats import RenderStats

__all__ = [
    "LOG_DEBUG",
    "LOG_INFO",
    "LOG_WARN",
    "LOG_ERROR",
    "LOG_FATAL",
    "get_logger",
    "log",
    "log_once",
    "set_debug",
    "Timer",
    "get_timer",
    "RenderStats",
]
