"""ProfileTrace: a ``torch.profiler`` trace of a window of steps
(mirrors ``dmme_tpu/callbacks/profile.py``).

Attach

.. code-block:: yaml

    trainer:
      callbacks:
        - class_path: dmme_tpu.callbacks.ProfileTrace
          init_args: {start_step: 10, num_steps: 5, log_dir: runs/profile}

and steps [start_step, start_step + num_steps) are traced into
``log_dir`` (``utils.profiling.Trace``: a ``*.pt.trace.json`` file that
TensorBoard's profiler plugin and chrome://tracing read). The window opens
after warm-up steps and closes on the JAX package's steps; a device sync
runs before the trace opens and before it closes, so the window holds the
window's steps only.
"""

from __future__ import annotations

from typing import Optional

from dmme_tpu_torch.utils import profiling
from dmme_tpu_torch.utils.profiling import sync


class ProfileTrace:
    """Trace steps [start_step, start_step + num_steps) into ``log_dir``."""

    def __init__(self, start_step: int = 10, num_steps: int = 5, log_dir: str = "profile"):
        self.start_step = start_step
        self.num_steps = num_steps
        self.log_dir = log_dir
        self._trace: Optional[profiling.Trace] = None
        self._started = False
        self._stopped = False
        #: the trace file written when the window closed
        self.path: Optional[str] = None

    def on_fit_start(self, lit, state, logger=None) -> None:
        if self.start_step <= 0 and not self._started:
            # a window anchored at step 0 can only open before any step runs
            self._start(state)

    def on_train_step_end(self, step: int, lit, state, logger=None, stride: int = 1) -> None:
        """``stride`` = steps run per hook firing (``steps_per_call``). With
        stride > 1 the window snaps to chunk boundaries: it opens at the last
        firing before ``start_step`` (up to ``stride - 1`` earlier steps land
        in the trace) and closes at the first firing at or past its end."""
        if self._stopped:
            return
        # the hook fires after steps (step - stride, step] ran: open at the
        # last firing with step < start_step, close at the window's last chunk
        if not self._started and step >= self.start_step - stride:
            self._start(state)
            return
        if self._started and step >= self.start_step + self.num_steps - 1:
            self._stop(state)

    def on_fit_end(self, lit, state, logger=None) -> None:
        if self._started and not self._stopped:  # short runs: close the trace
            self._stop(state)

    def _start(self, state) -> None:
        sync(state.params)  # drain pending work: trace only the window
        self._trace = profiling.Trace(self.log_dir)
        self._trace.start()
        self._started = True

    def _stop(self, state) -> None:
        sync(state.params)
        self.path = self._trace.stop()
        self._trace = None
        self._stopped = True
        print(f"[profile] trace written to {self.path}")
