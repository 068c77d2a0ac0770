"""Command-line interface (reference: esme/cli.py:5-21).

Counterpart of ``esme_tpu/cli.py``:

    python -m esme_tpu_torch.cli download --model esm2_650m [--cache-dir DIR]
    python -m esme_tpu_torch.cli score --model NAME_OR_PATH --seq SEQ \\
        [--batch-size 32] [--out scores.csv] [--device cuda]

``score`` writes the mask-margin scores of every single-residue
substitution (:func:`esme_tpu_torch.variant.predict_mask_margin`) as a CSV
with the header ``variant,score`` and one row per variant, to ``--out``
or to standard output (``-``). ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import csv
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog='esme-tpu-torch')
    sub = parser.add_subparsers(dest='cmd', required=True)

    dl = sub.add_parser('download', help='download pretrained weights')
    dl.add_argument('--model', required=True,
                    help='model name, e.g. esm2_650m')
    dl.add_argument('--cache-dir', default=None)

    sc = sub.add_parser('score', help='mask-margin score a sequence')
    sc.add_argument('--model', required=True,
                    help='model name or safetensors path')
    sc.add_argument('--seq', required=True)
    sc.add_argument('--batch-size', type=int, default=32)
    sc.add_argument('--out', default='-', help='csv output path')
    sc.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")

    args = parser.parse_args(argv)

    if args.cmd == 'download':
        from .download import download_model
        print(download_model(args.model, cache_dir=args.cache_dir))
        return 0

    from .models.esm import ESM
    from .variant import predict_mask_margin
    model = ESM.from_pretrained(args.model, device=args.device)
    scores = predict_mask_margin(model, args.seq, batch_size=args.batch_size)
    out = sys.stdout if args.out == '-' else \
        open(args.out, 'w', newline='')
    try:
        writer = csv.writer(out)
        writer.writerow(['variant', 'score'])
        writer.writerows(scores.items())
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
