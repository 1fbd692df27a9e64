"""CUDA runtime and driver calls that hand work to the card (kernel and
graph launches, asynchronous copies and memsets) per traced request.
Layer: the programs (``runtime.programs``: a captured program is one graph
launch and its input and output copies). Moves ``gpu_ms_per_job``."""


def read(records):
    trace = records.get("trace") or {}
    calls = trace.get("launch_calls")
    if not calls:
        return None
    return sum(calls.values()) / trace["units"]
