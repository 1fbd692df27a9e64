"""A scope that matmul-FLOP counts do not see.

``uncounted()`` takes back, when it closes, whatever the code inside added
to the ``torch.utils.flop_counter.FlopCounterMode`` counts open on this
thread: those on its dispatch-mode stack, which autograd carries into the
threads that run a backward. A count open on another thread keeps what it
counts meanwhile. The note-grid tail's plain versions run inside it
(mst_torch.ops.grid_kernel), so that the tail counts no matmul on any
route, as in the JAX package (mst_torch.runtime.flops). Imports torch only.
"""

from __future__ import annotations

import contextlib

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.flop_counter import FlopCounterMode


def _counters_here():
    """The FlopCounterModes on this thread's dispatch-mode stack."""
    found = []
    for mode in _get_current_dispatch_mode_stack():
        # the stack holds a helper mode that points at its FlopCounterMode
        counter = getattr(mode, "counter", mode)
        if isinstance(counter, FlopCounterMode) and \
                all(counter is not c for c in found):
            found.append(counter)
    return found


@contextlib.contextmanager
def uncounted():
    """What runs inside adds nothing to the counts open on this thread.
    Scopes nest. A count whose own code runs on two threads at once loses
    the other thread's matmuls while a scope is open."""
    saved = [(counter, {mod: dict(ops)
                        for mod, ops in counter.flop_counts.items()})
             for counter in _counters_here()]
    try:
        yield
    finally:
        for counter, counts in saved:
            counter.flop_counts.clear()
            for mod, ops in counts.items():
                counter.flop_counts[mod].update(ops)
