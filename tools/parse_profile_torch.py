#!/usr/bin/env python
"""Summarize a torch.profiler trace of the port (the ``trace.json`` that
``mst_torch.runtime.metrics.profiler_trace`` writes, as
``train-model-torch.py --profile-dir`` and
``tools/profile_transfer_device_torch.py`` do): device time by model
component and by kernel category, the top ops, and the longest idle gaps
with what the host ran across them. The counterpart of
tools/parse_profile.py, with its arguments:

    python tools/parse_profile_torch.py <trace_dir> [steps_in_trace]
        [measured_step_seconds]

A trace without device events (a CPU run) is summarized over the CPU ops'
self time and says ``"device": "cpu"``. Prints JSON.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from mst_torch.runtime.profile import summarize

    argv = sys.argv[1:] if argv is None else argv
    trace_dir = argv[0]
    n_steps = float(argv[1]) if len(argv) > 1 else 1.0
    step_s = float(argv[2]) if len(argv) > 2 else None
    print(json.dumps(summarize(trace_dir, n_steps, step_s), indent=1))


if __name__ == "__main__":
    main()
