"""The injectable-clock contract, copied from ``kubeflow_tpu/utils/clock.py``.

Every control loop takes ``clock: Optional[Clock] = None`` and defaults
it to the real clock BY REFERENCE (``self.clock = clock if clock is not
None else time.monotonic``), so tests can drive engine timing with a
fake clock.
"""

from __future__ import annotations

from typing import Callable

Clock = Callable[[], float]
