#!/usr/bin/env python
"""Style-transfer CLI of the PyTorch port: apply one or more style songs to
a composition (the counterpart of style-transfer.py).

    python style-transfer-torch.py composition.mid style1.mid [style2.mid ...] \
        --out outputs/ [--snapshots DIR | --weights NPZ | --seed S] \
        [--device cuda|cpu]

The weights come from the latest checkpoint that train-model-torch.py wrote
under ``--snapshots``, or from an npz export of a flax parameter tree
(``--weights``, flat ``a/b/c`` keys; tools/export_torch_assets.py writes
one from ``snapshots/``), or from a fresh init from ``--seed`` with the
velocity bias sparsified (``demo_params``, a structure demo). With none of
the three it is the committed ``snapshots/4900`` export. The default device
is the GPU; without one the run stops unless ``--device cpu`` is given.
"""

import argparse


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("composition")
    parser.add_argument("styles", nargs="+")
    parser.add_argument("--out", default="style_transfer_output/")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--snapshots", default=None,
                        help="checkpoint directory of train-model-torch.py")
    source.add_argument("--weights", default=None,
                        help="npz of flat flax params (default: the "
                             "committed snapshots/4900 export)")
    source.add_argument("--seed", type=int, default=None,
                        help="init seed of demo params instead of weights")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args()

    from mst_torch import weights
    from mst_torch.models import StyleTransferModel
    from mst_torch.transfer import ModelBundle, demo_params, transfer_style

    if args.snapshots:
        bundle = ModelBundle.from_checkpoint(args.snapshots,
                                             device=args.device)
    elif args.seed is not None:
        model = StyleTransferModel()
        model.load_state_dict(demo_params(seed=args.seed))
        bundle = ModelBundle(model=model, device=args.device)
    else:
        bundle = ModelBundle.from_npz(args.weights or weights.SNAPSHOT_NPZ,
                                      device=args.device)
    written = transfer_style(bundle, args.composition, args.styles, args.out)
    for path in written:
        print(path)


if __name__ == "__main__":
    main()
