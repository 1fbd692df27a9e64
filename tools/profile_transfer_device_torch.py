#!/usr/bin/env python
"""Device-time decomposition of mst_torch.transfer.transfer_styles with
torch.profiler, the counterpart of tools/profile_transfer_device.py:

    python tools/profile_transfer_device_torch.py [--trace DIR]
        [--requests 4] [--compositions A.mid ...] [--styles S.mid ...]
        [--device cuda]

It counts one request's matmul FLOPs on a run of its own
(``runtime.flops.MatmulFlops``), warms up with 3 more requests (the last
under the tracer, out of the trace: ``profiler_trace``'s warm-up), then
traces ``--requests`` requests under ``runtime.metrics.profiler_trace``
with the model's components annotated (``runtime.profile.model_scopes``),
and prints ``runtime.profile.summarize`` of the trace per request: device
time by component and kernel category, top ops, idle gaps, and the matmul
share of the card's peak. Inputs: the smoke request (3 compositions x 3 styles)
unless paths are given. The trace stays in ``--trace`` (default
``build/profile_transfer_device`` in the checkout) for
``tools/parse_profile_torch.py``. ``--device cpu`` summarizes the CPU ops
instead (for the tests); the default is ``cuda``, and without a card it
raises. The bundle runs with ``capture=False``: a replayed CUDA graph
carries no ``record_function`` scope, so ``summarize`` could not
attribute its kernels to model components (mst_torch.runtime.programs);
the requests are the same programs, run eagerly.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

WARMUP = 3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace", default=os.path.join(
        ROOT, "build", "profile_transfer_device"))
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--compositions", nargs="+", default=None)
    parser.add_argument("--styles", nargs="+", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from mst_torch.runtime.flops import MatmulFlops, device_peak_flops
    from mst_torch.runtime.metrics import profiler_trace
    from mst_torch.runtime.profile import model_scopes, summarize
    from mst_torch.transfer import ModelBundle, transfer_styles
    from profile_transfer_torch import smoke_request

    comps, styles = smoke_request()
    comps = args.compositions or comps
    styles = args.styles or styles
    bundle = ModelBundle.from_npz(device=args.device, capture=False)
    device = bundle.device
    with tempfile.TemporaryDirectory() as out:
        with MatmulFlops() as count:
            transfer_styles(bundle, comps, styles,
                            os.path.join(out, "counted"))
        for i in range(WARMUP - 1):
            transfer_styles(bundle, comps, styles,
                            os.path.join(out, f"warm_{i}"))
        # the last warm-up request runs under the tracer, out of the trace
        with profiler_trace(args.trace) as end_warmup, \
                model_scopes(bundle.model):
            transfer_styles(bundle, comps, styles,
                            os.path.join(out, "warm_traced"))
            end_warmup()
            for i in range(args.requests):
                transfer_styles(bundle, comps, styles,
                                os.path.join(out, f"traced_{i}"))
    peak = (device_peak_flops(bundle.model.config.compute_dtype, device)
            if device.type == "cuda" else None)
    summary = summarize(args.trace, args.requests,
                        flops=count.total * args.requests, peak_flops=peak,
                        device=device.type)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"trace: {args.trace} ({args.requests} requests of "
          f"{len(comps)} x {len(styles)}, on {name}); per request:")
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
