"""The replayed request over a device mesh against the single-card one,
whole and stage by stage, at two or more batch sizes:

    python tools/profile_mesh_torch.py [--shards 4] [--rounds 6]
        [--repeat-styles 1 5] [--compositions A.mid ...]
        [--styles S.mid ...] [--device cuda]

The mesh is every visible card up to ``--shards``, or two shards on
``cuda:0`` when there is one card; ``--device cpu`` lays ``--shards``
shards on the CPU (for the tests). Both bundles (``ModelBundle(mesh=...)``
and ``ModelBundle(device=...)``) hold the committed ``snapshots/4900``
weights and capture their programs on the card.

For each ``--repeat-styles`` K the styles are the given ones and K - 1
copies of each under new names, so the request has C x (1 + S x K) jobs
(the smoke request, 3 compositions x 3 styles: 12 jobs at K = 1, 48 at
K = 5). Each bundle runs requests until one captures nothing; then
``--rounds`` turns of one request each, each bundle first in every other
turn (wall time: median, min, max); then ``--rounds`` turns of a request
timed by ``transfer_styles(..., stage=StageTimer(cards))``, whose stages
wait for every card of the bundle at their exit (the originals are then
decoded alone, and 2c and 5b-5d do not wait):

- 1-6 and 2a, 6a: tools/profile_transfer_torch.py's stages;
- 2c: each shard's extraction dispatch (its inputs copied, its graph
  replayed); 2b: the gather of the real songs' latents onto the first
  card, after stage 3 has waited for every shard's extraction;
- 5a: the latents' copy to every other card; 5b: each shard's apply
  dispatch; 5c: each shard's fetch, in shard order (the wait for its
  card's work and the copy to the host); 5d: the fetched buffers joined
  without the pad rows and converted to uint32.

It prints a report and one JSON line with every number, the card's name
and power limit (``nvidia-smi``) and the file check: every file of the
mesh request against the single-card one's, byte-equal or differing only
in fp32-boundary cells (mst_torch.parity; raises otherwise).
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.profile_transfer_torch import smoke_request  # noqa: E402


def make_mesh(device: str, shards: int):
    """(the mesh, a description of its layout)."""
    import torch

    from mst_torch.parallel import create_device_mesh

    if device == "cpu":
        return (create_device_mesh(shards, devices=["cpu"] * shards),
                f"{shards} shards on the CPU")
    n = min(torch.cuda.device_count(), shards)
    if n >= 2:
        return create_device_mesh(n), f"{n} cards, one shard each"
    return (create_device_mesh(2, devices=["cuda:0"] * 2),
            "one card: two shards on cuda:0")


def repeated(styles, k: int, out: str):
    """The style paths and k - 1 copies of each under new names."""
    paths = list(styles)
    os.makedirs(os.path.join(out, "styles"), exist_ok=True)
    for r in range(1, k):
        for path in styles:
            stem = os.path.splitext(os.path.basename(path))[0]
            copy = os.path.join(out, "styles", f"{stem}_copy{r}.mid")
            shutil.copyfile(path, copy)
            paths.append(copy)
    return paths


def _cards(bundle):
    return list(dict.fromkeys(d for d in bundle.shard_devices
                              if d.type == "cuda"))


def _graphs(bundle) -> int:
    programs = {id(bundle.replica(s)[2]): bundle.replica(s)[2]
                for s in range(bundle.data_axis_size())}
    return sum(len(p.graphs) for p in programs.values())


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names
                  if f.endswith(".mid"))


def compare_files(root, want_root):
    """(files byte-equal, files) of one request against another's; raises
    on another file set or a difference beyond an fp32-boundary cell."""
    from mst_torch.parity import midi_differences

    names = _files(want_root)
    if _files(root) != names:
        raise AssertionError(f"{root}: other files than {want_root}")
    equal = 0
    for name in names:
        with open(os.path.join(root, name), "rb") as a, \
                open(os.path.join(want_root, name), "rb") as b:
            same, faults, _ = midi_differences(a.read(), b.read())
        if faults:
            raise AssertionError(f"{name}: {faults}")
        equal += same
    return equal, len(names)


def profile_batch(bundles, comps, styles, out, rounds):
    """Capture, ``rounds`` timed turns and ``rounds`` staged turns of the
    request on each of ``bundles`` ({label: bundle}, the first the mesh's).
    Returns {label: result} and the file check."""
    import torch

    from mst_torch.runtime.profile import StageTimer
    from mst_torch.transfer import transfer_styles

    def request(bundle, name, stage=None):
        t0 = time.perf_counter()
        transfer_styles(bundle, comps, styles, os.path.join(out, name),
                        stage=stage)
        for card in _cards(bundle):
            torch.cuda.synchronize(card)
        return time.perf_counter() - t0

    for label, bundle in bundles.items():
        for r in range(3):
            held = _graphs(bundle)
            request(bundle, f"{label}_capture_{r}")
            if _graphs(bundle) == held:
                break
        else:
            raise AssertionError(f"{label}: a third request still captured")
    held = {label: _graphs(b) for label, b in bundles.items()}
    labels = list(bundles)
    walls = {label: [] for label in labels}
    timers = {label: StageTimer(b.shard_devices)
              for label, b in bundles.items()}
    for r in range(rounds):
        for label in labels[::-1] if r % 2 else labels:
            walls[label].append(request(bundles[label], f"{label}_{r}"))
    for r in range(rounds):
        for label in labels[::-1] if r % 2 else labels:
            request(bundles[label], f"{label}_staged_{r}", timers[label])
    if {label: _graphs(b) for label, b in bundles.items()} != held:
        raise AssertionError("a timed request captured a program")
    results = {}
    for label in labels:
        stages = {name: t / rounds * 1e3
                  for name, t in sorted(timers[label].times.items())}
        results[label] = {
            "wall_ms": [t * 1e3 for t in walls[label]],
            "median_ms": statistics.median(walls[label]) * 1e3,
            "min_ms": min(walls[label]) * 1e3,
            "max_ms": max(walls[label]) * 1e3,
            "stages_ms": stages,
            "stage_sum_ms": sum(stages.values()),
            "graphs": held[label],
        }
    equal, n_files = compare_files(os.path.join(out, f"{labels[0]}_0"),
                                   os.path.join(out, f"{labels[1]}_0"))
    return results, {"byte_equal": equal, "files": n_files}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def report(result) -> str:
    lines = [f"mesh: {result['mesh']}; {result['cards']}"]
    for batch in result["batches"]:
        lines.append(f"{batch['jobs']} jobs, {result['rounds']} turns "
                     f"(files: {batch['files']['byte_equal']} of "
                     f"{batch['files']['files']} byte-equal):")
        for label, r in batch["bundles"].items():
            lines.append(f"  {label}: wall median {r['median_ms']:.3f} ms "
                         f"(min {r['min_ms']:.3f}, max {r['max_ms']:.3f}); "
                         f"{r['graphs']} graphs; staged sum "
                         f"{r['stage_sum_ms']:.3f} ms")
            for name, ms in r["stages_ms"].items():
                lines.append(f"    {name:<40} {ms:10.3f} ms/round")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--repeat-styles", type=int, nargs="+",
                        default=[1, 5])
    parser.add_argument("--compositions", nargs="+", default=None)
    parser.add_argument("--styles", nargs="+", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from mst_torch.device import resolve_device
    from mst_torch.transfer import ModelBundle

    device = resolve_device(args.device)
    comps, styles = smoke_request()
    comps = args.compositions or comps
    styles = args.styles or styles
    mesh, layout = make_mesh(device.type, args.shards)
    bundles = {"mesh": ModelBundle.from_npz(mesh=mesh),
               "single": ModelBundle.from_npz(device=device)}
    result = {"mesh": layout, "cards": (card_line() if device.type == "cuda"
                                        else "cpu"),
              "rounds": args.rounds, "batches": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k in args.repeat_styles:
            out = os.path.join(tmp, f"repeat_{k}")
            batch_styles = repeated(styles, k, out)
            per_bundle, files = profile_batch(bundles, comps, batch_styles,
                                              out, args.rounds)
            result["batches"].append({
                "repeat_styles": k,
                "jobs": len(comps) * (1 + len(batch_styles)),
                "bundles": per_bundle, "files": files})
    print(report(result))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
