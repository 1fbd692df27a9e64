#!/usr/bin/env python
"""Offline corpus analysis of the PyTorch port (the counterpart of
corpus-stats.py, on mst_torch.analysis, mst_torch.utils and
mst_torch.theory): per-song key/tempo/size stats and key-mass
distributions, as the reference's notebooks did with get_keys_dist +
list2df (style/midi_conversion.py:327-346, style/utils/data.py:11-24).

    python corpus-stats-torch.py DIR [--sample N --seed S] [--out CSV]

Writes one CSV row per (song, instrument channel) with the per-key
duration*velocity mass in seconds, plus a per-song summary table to stdout
(through pandas). Host code only: no device. Its CSV is byte-equal to
corpus-stats.py's on the same corpus and seed.
"""

import argparse
import glob
import os


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data", help="corpus directory (searched for **/*.mid)")
    parser.add_argument("--sample", type=int, default=None,
                        help="analyze a random subset of this many files")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="corpus-stats.csv")
    args = parser.parse_args()

    import numpy as np

    from mst_torch.analysis import keys_dist
    from mst_torch.exceptions import MidiFormatError
    from mst_torch.io.midi import PROGRAM_TO_INSTRUMENT, load_midi_from_file
    from mst_torch.ops.events import pair_notes, read_midi
    from mst_torch.theory import (
        KEY_NAMES, detect_scales_batch, keys_dist_from_notes)
    from mst_torch.utils import (group_by, list2df, random_sample, save_to_csv)

    files = sorted(glob.glob(os.path.join(args.data, "**/*.mid"),
                             recursive=True))
    if args.sample:
        files = random_sample(files, args.sample,
                              rng=np.random.default_rng(args.seed))

    rows, summaries, dists = [], [], []
    for path in files:
        mid = load_midi_from_file(path)
        if mid is None:
            continue
        try:
            channels, info = read_midi(mid)
        except MidiFormatError:
            continue
        # merge channels sharing an instrument, as the pipeline does
        by_instrument = group_by(channels, key="instrument_id")
        all_keys, all_weights = [], []
        for instrument_id, group in by_instrument.items():
            notes_list = [pair_notes(c["messages"]) for c in group]
            name = PROGRAM_TO_INSTRUMENT.get(instrument_id, str(instrument_id))
            for notes in notes_list:
                if not len(notes):
                    continue
                row = keys_dist(info, notes, instrument_name=name)
                row.update(file=os.path.basename(path),
                           instrument_id=instrument_id, n_notes=len(notes))
                rows.append(row)
                if instrument_id >= 0:
                    all_keys.append(notes.note_id % 12)
                    all_weights.append(
                        notes.duration.astype(np.float64) * notes.velocity)
        if all_keys:
            dists.append((len(summaries),
                          keys_dist_from_notes(np.concatenate(all_keys),
                                               np.concatenate(all_weights))))
        summaries.append(dict(
            file=os.path.basename(path), key="", mode="",
            bpm=info.bpm, n_bars=int(info.n_bars),
            n_channels=len(channels),
            time_signature=f"{info.numerator}/{info.denominator}"))

    if not summaries:
        raise SystemExit("no readable .mid files found")

    # ONE vectorized (B, 24) scoring pass for the whole corpus instead of a
    # per-song loop (detect_scales_batch is the batched argmin detector)
    if dists:
        tonics, minors = detect_scales_batch(
            np.stack([d for _, d in dists]))
        for (i, _), tonic, minor in zip(dists, tonics, minors):
            summaries[i]["key"] = KEY_NAMES[int(tonic)]
            summaries[i]["mode"] = "minor" if minor else "major"

    df = list2df(summaries, columns=("file", "key", "mode", "bpm", "n_bars",
                                     "n_channels", "time_signature"))
    print(df.to_string(index=False))
    print(f"\n{len(summaries)} songs, {len(rows)} instrument channels")

    fieldnames = ["file", "instrument", "instrument_id", "n_notes",
                  *KEY_NAMES]
    save_to_csv(args.out, data=[{k: r.get(k, 0.0) for k in fieldnames}
                                for r in rows],
                fieldnames=fieldnames, when_exists="overwrite")
    print(f"per-channel key masses -> {args.out}")


if __name__ == "__main__":
    main()
