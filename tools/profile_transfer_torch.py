"""Stage-level wall-clock breakdown of mst_torch.transfer.transfer_styles,
the counterpart of tools/profile_transfer.py:

    python tools/profile_transfer_torch.py [--compositions A.mid ...]
        [--styles S.mid ...] [--out DIR] [--rounds 3] [--device cuda]

After one warm-up it runs ``--rounds`` rounds of the request timed stage
by stage (``transfer_styles(..., stage=timer)``, the request's own code)
and prints the ms per round of each stage, its share, the stages' sum, the
timed round's wall time and the wall time of a plain ``transfer_styles``
call on the same inputs (which overlaps stage 4 with stage 5; a timed
request runs stage 4 alone). Stages (``transfer.REQUEST_STAGES``):

1. ingest: SMF parse and model input of every song;
2. extract dispatch: the extraction batches queued on the device, without
   2a. note-record prep, the host side of their rasterization (K1's
   records: quantize, ``encode_notes``, ``concat_and_pad``);
3. extract block: the wait for the extraction's device work;
4. originals decode+write: the original/ files;
5. apply dispatch+fetch: the job grouping (``transfer.plan_jobs``) and
   each group's apply, records fetched;
6. styled decode+write: each job's ``.mid`` write, without
   6a. packed-job decode, its records decoded to MIDI messages;

and out of 2 and 5 the stages of each shard (one here): 2c its
extraction dispatch, 5a the latents' copy to its card, 5b its apply
dispatch, 5c its fetch, and 5d the fetched buffer's conversion
(tools/profile_mesh_torch.py times them over a device mesh).

On a CUDA device each stage waits for the card at its exit (stage 2 and
2a excepted, so stage 3 owns the extraction's device work). The bundle
runs with ``fuse_requests=False``, so that extraction and apply are
programs of their own, and with ``capture=False``: its programs run
eagerly, as their CUDA graphs would hide the launches that stages 2 and 5
time (mst_torch.runtime.programs; a replayed graph carries no
``record_function`` scope either). Inputs: the
smoke request (``mst_torch/assets/smoke``: 3 compositions x 3 styles, 12
jobs) unless paths are given. ``--device cpu`` runs the CPU port (for the
tests); the default is ``cuda``, and without a card it raises. Files go
under ``--out`` (``staged_<r>/`` and ``request_<r>/``), by default a
temporary directory that is removed. The weights are the committed
``snapshots/4900`` export.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def smoke_request():
    """(composition paths, style paths) of the smoke request."""
    smoke = os.path.join(ROOT, "mst_torch", "assets", "smoke")
    with open(os.path.join(smoke, "manifest.json")) as fh:
        names = [s["name"] for s in json.load(fh)["songs"]]
    paths = {prefix: [os.path.join(smoke, f"{n}.mid") for n in names
                      if n.startswith(prefix)]
             for prefix in ("comp_", "style_")}
    return paths["comp_"], paths["style_"]


def profile_rounds(bundle, compositions, styles, out, rounds):
    """One warm-up, then ``rounds`` rounds of a timed request and a plain
    ``transfer_styles`` call. Returns the summary that ``main`` prints."""
    import torch

    from mst_torch.runtime.profile import StageTimer
    from mst_torch.transfer import REQUEST_STAGES, transfer_styles

    device = bundle.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    transfer_styles(bundle, compositions, styles,
                    os.path.join(out, "warmup"), stage=StageTimer(device))
    transfer_styles(bundle, compositions, styles,
                    os.path.join(out, "warmup_request"))
    timer = StageTimer(device)
    staged_s, request_s = [], []
    for r in range(rounds):
        sync()
        t0 = time.perf_counter()
        transfer_styles(bundle, compositions, styles,
                        os.path.join(out, f"staged_{r}"), stage=timer)
        sync()
        staged_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        transfer_styles(bundle, compositions, styles,
                        os.path.join(out, f"request_{r}"))
        sync()
        request_s.append(time.perf_counter() - t0)
    # every stage of REQUEST_STAGES, and the shards' stages (2c, 5a-5d)
    names = sorted(set(REQUEST_STAGES) | set(timer.times))
    stages_ms = {name: timer.times.get(name, 0.0) / rounds * 1e3
                 for name in names}
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "rounds": rounds,
        "jobs": len(compositions) * (1 + len(styles)),
        "stages_ms": stages_ms,
        "stage_sum_ms": sum(stages_ms.values()),
        "staged_ms": sum(staged_s) / rounds * 1e3,
        "request_ms": sum(request_s) / rounds * 1e3,
        "staged_round_ms": [t * 1e3 for t in staged_s],
        "request_round_ms": [t * 1e3 for t in request_s],
    }


def report(result) -> str:
    total = result["stage_sum_ms"]
    lines = [f"{result['rounds']} rounds of {result['jobs']} jobs on "
             f"{result['device']}:"]
    for name, ms in result["stages_ms"].items():
        lines.append(f"  {name:<34} {ms:10.3f} ms/round "
                     f"({100 * ms / max(total, 1e-12):5.1f}%)")
    lines.append(f"  stages' sum {total:.3f} ms; staged round (originals "
                 f"alone) {result['staged_ms']:.3f} ms; transfer_styles "
                 f"(originals overlapped with the apply) "
                 f"{result['request_ms']:.3f} ms")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compositions", nargs="+", default=None)
    parser.add_argument("--styles", nargs="+", default=None)
    parser.add_argument("--out", default=None,
                        help="output directory (default: a temporary one)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from mst_torch.transfer import ModelBundle

    comps, styles = smoke_request()
    comps = args.compositions or comps
    styles = args.styles or styles
    bundle = ModelBundle.from_npz(device=args.device, fuse_requests=False,
                                  capture=False)
    with tempfile.TemporaryDirectory() as tmp:
        result = profile_rounds(bundle, comps, styles, args.out or tmp,
                                args.rounds)
    print(report(result))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
