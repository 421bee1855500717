"""Offline ScanNet-v2 preprocessing: raw scans -> one ``.npz`` a scene, the
port's counterpart of ``scripts/preprocess_scannet.py``::

    python -m gspn_tpu_torch.data.preprocess_scannet --scans <scannet>/scans \
        --out scannet_npz [--label-tsv scannetv2-labels.combined.tsv]

Each scan directory holds ``<id>_vh_clean_2.ply``,
``<id>_vh_clean_2.0.010000.segs.json`` and ``<id>.aggregation.json`` (the
ScanNet release layout); a directory missing one is skipped with a line
saying so. ``train_gspn``, ``train_rpointnet`` and ``run_eval`` read the
output directory with ``--scannet-dir``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from gspn_tpu_torch.data.scannet import load_label_tsv, preprocess_to_npz


def main(argv=None) -> list[pathlib.Path]:
    p = argparse.ArgumentParser(description="ScanNet scans -> per-scene .npz")
    p.add_argument("--scans", required=True, help="dir of scan directories")
    p.add_argument("--out", required=True)
    p.add_argument("--label-tsv", default=None)
    args = p.parse_args(argv)

    label_map = load_label_tsv(args.label_tsv) if args.label_tsv else None
    scans = sorted(d for d in pathlib.Path(args.scans).iterdir() if d.is_dir())
    if not scans:
        sys.exit(f"no scan directories under {args.scans}")
    written = []
    for i, scan in enumerate(scans):
        try:
            out = preprocess_to_npz(scan, args.out, label_map)
        except FileNotFoundError as e:
            print(f"[{i + 1}/{len(scans)}] {scan.name}: SKIP ({e})")
            continue
        print(f"[{i + 1}/{len(scans)}] {scan.name} -> {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
