"""ShapeNet single-object loader (HDF5), the port's copy of
``gspn_tpu/data/shapenet.py``: the CVAE pretraining workload (BASELINE.json
config 1: ShapeNet chair, N=1024).

Expects pointnet2-style h5 files: datasets ``data (B, N, 3)`` and
``label (B,)`` (category id). A category filter selects e.g. chairs.

Rows are streamed from the h5 files on demand (labels, a few bytes an
object, are indexed eagerly); real ShapeNet splits never need to fit in
host RAM. Per-object normalization happens at sample time, identically
to normalizing eagerly.
"""

from __future__ import annotations

import pathlib

import numpy as np


class ShapeNetObjects:
    def __init__(
        self,
        h5_dir: str,
        num_points: int = 1024,
        category: int | None = None,
        normalize: bool = True,
    ):
        import h5py

        paths = sorted(pathlib.Path(h5_dir).glob("*.h5"))
        if not paths:
            raise FileNotFoundError(f"no .h5 files under {h5_dir}")
        self._files = [h5py.File(p, "r") for p in paths]
        file_of, row_of, labels = [], [], []
        for fi, f in enumerate(self._files):
            lab = np.asarray(f["label"][:]).reshape(-1).astype(np.int32)
            nrows = f["data"].shape[0]
            if len(lab) != nrows:
                raise ValueError(f"label/data row mismatch in {paths[fi]}")
            file_of.append(np.full(nrows, fi, np.int32))
            row_of.append(np.arange(nrows, dtype=np.int64))
            labels.append(lab)
        self._file_of = np.concatenate(file_of)
        self._row_of = np.concatenate(row_of)
        self.label = np.concatenate(labels)
        if category is not None:
            sel = self.label == category
            self._file_of = self._file_of[sel]
            self._row_of = self._row_of[sel]
            self.label = self.label[sel]
        if len(self.label) == 0:
            raise ValueError(f"no objects (category={category}) under {h5_dir}")
        self.num_points = num_points
        self.normalize = normalize

    def __len__(self):
        return len(self.label)

    def _read_rows(self, idx: np.ndarray) -> np.ndarray:
        """Gather object point sets for global row ids (streamed)."""
        out = [None] * len(idx)
        files = self._file_of[idx]
        rows = self._row_of[idx]
        for fi in np.unique(files):
            where = np.where(files == fi)[0]
            # h5py fancy indexing needs strictly increasing: read uniques
            uniq = np.unique(rows[where])
            data = self._files[fi]["data"][uniq.tolist()]
            pos = np.searchsorted(uniq, rows[where])
            for oi, pi in zip(where, pos):
                out[oi] = np.asarray(data[pi], np.float32)
        return np.stack(out)

    def sample_batch(self, rng: np.random.Generator, batch: int) -> dict:
        """Batch in the standard scene layout: the whole object is one
        instance (id 1) so the CVAE trainer can consume it unchanged."""
        idx = rng.integers(0, len(self), batch)
        pts = self._read_rows(idx)
        if self.normalize:
            pts = pts - pts.mean(axis=1, keepdims=True)
            scale = np.abs(pts).max(axis=(1, 2), keepdims=True)
            pts = pts / np.maximum(scale, 1e-9)
        n = pts.shape[1]
        if n >= self.num_points:
            cols = rng.choice(n, self.num_points, replace=False)
            pts = pts[:, cols]
        else:
            reps = rng.integers(0, n, self.num_points - n)
            pts = np.concatenate([pts, pts[:, reps]], axis=1)
        b, npts = pts.shape[0], pts.shape[1]
        return {
            "xyz": pts.astype(np.float32),
            "features": np.zeros((b, npts, 0), np.float32),
            "valid": np.ones((b, npts), bool),
            "sem_label": np.ones((b, npts), np.int32),
            "inst_label": np.ones((b, npts), np.int32),
        }
