"""Pod-name–tagged logging.  Parity: reference python/common/log_utils.py
(SURVEY.md C22)."""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[{pod}] [%(name)s:%(lineno)d] %(message)s"
)


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        pod = os.environ.get("HOSTNAME", "local")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT.format(pod=pod)))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level)
    return logger
