#!/usr/bin/env python
"""Batched style-transfer CLI of the PyTorch port: N compositions x M
styles in grouped device batches (the counterpart of
batch-style-transfer.py, over mst_torch.transfer.transfer_styles).

    python batch-style-transfer-torch.py --compositions a.mid b.mid \
        --styles s1.mid s2.mid --out outputs/ \
        [--snapshots DIR | --weights NPZ] [--seed 0] [--device cuda|cpu]

All songs are latent-extracted in batches grouped by (beats per bar,
percussion), and every (reconstructed + styled) job of a group runs as one
apply batch. The weights come from the latest checkpoint that
train-model-torch.py wrote under ``--snapshots``, or from an npz export
(``--weights``, flat flax ``a/b/c`` keys), or else from a fresh init from
``--seed`` with the velocity bias sparsified (``demo_params``, a structure
demo). The default device is the GPU; without one the run stops unless
``--device cpu`` is given. It prints one written path per line.
"""

import argparse


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--compositions", nargs="+", required=True)
    parser.add_argument("--styles", nargs="+", required=True)
    parser.add_argument("--out", default="style_transfer_output/")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--snapshots", default=None,
                        help="checkpoint directory of train-model-torch.py")
    source.add_argument("--weights", default=None,
                        help="npz of flat flax params")
    parser.add_argument("--seed", type=int, default=0,
                        help="init seed of the demo params (used without "
                             "--snapshots and --weights)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args()

    from mst_torch.models import StyleTransferModel
    from mst_torch.transfer import ModelBundle, demo_params, transfer_styles

    if args.snapshots:
        bundle = ModelBundle.from_checkpoint(args.snapshots,
                                             device=args.device)
    elif args.weights:
        bundle = ModelBundle.from_npz(args.weights, device=args.device)
    else:
        model = StyleTransferModel()
        model.load_state_dict(demo_params(seed=args.seed))
        bundle = ModelBundle(model=model, device=args.device)
    written = transfer_styles(bundle, args.compositions, args.styles,
                              args.out)
    for path in written:
        print(path)


if __name__ == "__main__":
    main()
