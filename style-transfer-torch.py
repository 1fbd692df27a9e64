#!/usr/bin/env python
"""Style-transfer CLI of the PyTorch port: apply one or more style songs to
a composition (the counterpart of style-transfer.py).

    python style-transfer-torch.py composition.mid style1.mid [style2.mid ...] \
        --out outputs/ [--weights mst_torch/assets/snapshot_4900.npz] \
        [--device cuda|cpu]

The weights are an npz export of a flax parameter tree (flat ``a/b/c``
keys; tools/export_torch_assets.py writes one from ``snapshots/``). The
default device is the GPU; without one the run stops unless ``--device
cpu`` is given.
"""

import argparse


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("composition")
    parser.add_argument("styles", nargs="+")
    parser.add_argument("--out", default="style_transfer_output/")
    parser.add_argument("--weights", default=None,
                        help="npz of flat flax params (default: the "
                             "committed snapshots/4900 export)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args()

    from mst_torch import weights
    from mst_torch.transfer import ModelBundle, transfer_style

    bundle = ModelBundle.from_npz(args.weights or weights.SNAPSHOT_NPZ,
                                  device=args.device)
    written = transfer_style(bundle, args.composition, args.styles, args.out)
    for path in written:
        print(path)


if __name__ == "__main__":
    main()
