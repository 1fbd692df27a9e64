#!/usr/bin/env python
"""Export what the PyTorch port needs from the JAX package, as plain files.

The port (``mst_torch``) runs where neither JAX nor orbax is installed, so it
cannot read the OCDBT snapshot under ``snapshots/`` or run
``tools/make_corpus.py`` (which imports ``mst_tpu``). This tool, run where the
JAX package works, writes:

- ``mst_torch/assets/snapshot_4900.npz``: the trained params of the latest
  snapshot, fp32, one entry per leaf under its flat ``a/b/c`` flax path
  (relative to ``params``). The snapshot is restored from a temporary copy of
  ``snapshots/``, because the orbax manager is opened with ``create=True`` and
  nothing may be written under ``snapshots/``.
- ``mst_torch/assets/smoke/*.mid``: a fixed set of synthetic songs from
  ``make_corpus.generate_song`` — the first seeds (from 0 up) whose song is in
  4/4, has percussion, has 65..128 ingested bars and at most 8 pitched
  channels. The first three are compositions, the last three styles; the
  seeds and shapes are written to ``smoke/manifest.json``.

    python tools/export_torch_assets.py            # both
    python tools/export_torch_assets.py --only midi
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from mst_torch.weights import ASSETS, flatten_tree  # noqa: E402

N_COMPOSITIONS = 3
N_STYLES = 3


def restore_snapshot_params(snapshots_dir):
    """(flat params, step) of the latest snapshot, restored from a temporary
    copy of ``snapshots_dir``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mst_tpu.models import StyleTransferModel
    from mst_tpu.runtime.checkpoint import load_trained_params

    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "snapshots")
        shutil.copytree(snapshots_dir, copy)
        params, step = load_trained_params(StyleTransferModel(), copy)
    if params is None:
        raise FileNotFoundError(f"no snapshot under {snapshots_dir}")
    flat = flatten_tree(jax.device_get(params)["params"])
    return {k: v.astype(np.float32) for k, v in flat.items()}, step


def export_snapshot(out_path):
    flat, step = restore_snapshot_params(os.path.join(ROOT, "snapshots"))
    np.savez(out_path, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {out_path}: step {step}, {len(flat)} leaves, {n} params")


def export_midi(out_dir):
    from make_corpus import generate_song
    from mst_tpu.io import create_midi, native
    from mst_tpu.transfer import get_model_input

    os.makedirs(out_dir, exist_ok=True)
    picked = []
    seed = 0
    with tempfile.TemporaryDirectory() as tmp:
        while len(picked) < N_COMPOSITIONS + N_STYLES:
            info, instruments = generate_song(np.random.default_rng(seed))
            seed += 1
            if (info["time_signature"]["numerator"] != 4
                    or not any(i["channel_id"] == 9 for i in instruments)):
                continue
            path = os.path.join(tmp, "probe.mid")
            native.write_midi_file(path, create_midi(info, *instruments))
            song = get_model_input(path)[1]
            n_channels, n_bars = song.pitched_shape[:2]
            if (not 65 <= n_bars <= 128 or n_channels > 8
                    or song.unpitched_shape is None):
                continue
            k = len(picked)
            name = (f"comp_{k}" if k < N_COMPOSITIONS
                    else f"style_{k - N_COMPOSITIONS}")
            shutil.copy(path, os.path.join(out_dir, f"{name}.mid"))
            picked.append({"name": name, "seed": seed - 1,
                           "bars": int(n_bars),
                           "pitched_channels": int(n_channels)})
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump({"generator": "tools/make_corpus.py:generate_song",
                   "rng": "numpy.random.default_rng(seed)",
                   "songs": picked}, fh, indent=1)
    print(f"wrote {len(picked)} songs to {out_dir}: {picked}")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--only", choices=("snapshot", "midi"))
    args = parser.parse_args()
    if args.only in (None, "snapshot"):
        export_snapshot(os.path.join(ASSETS, "snapshot_4900.npz"))
    if args.only in (None, "midi"):
        export_midi(os.path.join(ASSETS, "smoke"))


if __name__ == "__main__":
    main()
