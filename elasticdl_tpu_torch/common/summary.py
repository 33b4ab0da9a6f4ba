"""TensorBoard scalar summaries (the port's copy of the JAX package's
common/summary.py), written through `torch.utils.tensorboard`.

Optional, as in the JAX package: with no directory set the writer does
nothing, and without the `tensorboard` package (which
`torch.utils.tensorboard` needs) it does nothing after one warning, as
the JAX writer does without TensorFlow.  `active` and `reason` say which
case holds.
"""

from __future__ import annotations

from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)


class SummaryWriter:
    """Scalars to TensorBoard event files under `log_dir`; a no-op when
    the package is missing or no `log_dir` is set."""

    def __init__(self, log_dir: Optional[str] = None):
        self._writer = None
        self.log_dir = log_dir or ""
        if not log_dir:
            self.reason = "no log directory"
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError as exc:
            self.reason = f"tensorboard unavailable ({exc})"
            logger.warning("tensorboard unavailable; summaries to %s "
                           "disabled", log_dir)
            return
        self._writer = _Writer(log_dir=log_dir)
        self.reason = "writing"

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalars(self, values: Dict[str, float], step: int):
        if self._writer is None:
            return
        for name, value in values.items():
            self._writer.add_scalar(name, float(value), global_step=step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
