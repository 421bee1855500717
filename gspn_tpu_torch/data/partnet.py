"""PartNet part-instance loader (HDF5), the port's copy of
``gspn_tpu/data/partnet.py``: BASELINE.json config 5's second dataset.
Part instances play the role of scene object instances.

Expects PartNet ins_seg h5 layout: ``pts (B, N, 3)``, per-point semantic
``label`` (or ``sem_label``) and instance ``ins_label`` (or
``inst_label``); key names are probed. Rows stream from the files on
demand; real PartNet (millions of points per split) never needs to fit
in host RAM.
"""

from __future__ import annotations

import pathlib

import numpy as np

_PTS_KEYS = ("pts", "data", "points")
_SEM_KEYS = ("label", "sem_label", "label_seg", "semantic")
_INS_KEYS = ("ins_label", "inst_label", "instance", "pid")


def _pick(f, keys):
    for k in keys:
        if k in f:
            return k
    raise KeyError(f"none of {keys} in h5 file (has {list(f.keys())})")


class PartNetParts:
    def __init__(self, h5_dir: str, num_points: int = 4096):
        import h5py

        paths = sorted(pathlib.Path(h5_dir).glob("*.h5"))
        if not paths:
            raise FileNotFoundError(f"no .h5 files under {h5_dir}")
        self._files = []
        self._keys = []
        file_of, row_of = [], []
        for fi, p in enumerate(paths):
            f = h5py.File(p, "r")
            pk, sk, ik = _pick(f, _PTS_KEYS), _pick(f, _SEM_KEYS), _pick(f, _INS_KEYS)
            self._files.append(f)
            self._keys.append((pk, sk, ik))
            nrows = f[pk].shape[0]
            file_of.append(np.full(nrows, fi, np.int32))
            row_of.append(np.arange(nrows, dtype=np.int64))
        self._file_of = np.concatenate(file_of)
        self._row_of = np.concatenate(row_of)
        self.num_points = num_points

    def __len__(self):
        return len(self._file_of)

    def _read_rows(self, idx: np.ndarray):
        pts = [None] * len(idx)
        sem = [None] * len(idx)
        ins = [None] * len(idx)
        files = self._file_of[idx]
        rows = self._row_of[idx]
        for fi in np.unique(files):
            where = np.where(files == fi)[0]
            # h5py fancy indexing needs strictly increasing: read uniques
            uniq = np.unique(rows[where])
            f = self._files[fi]
            pk, sk, ik = self._keys[fi]
            p = f[pk][uniq.tolist()]
            s = f[sk][uniq.tolist()]
            i = f[ik][uniq.tolist()]
            pos = np.searchsorted(uniq, rows[where])
            for oi, pi in zip(where, pos):
                pts[oi] = np.asarray(p[pi], np.float32)
                sem[oi] = np.asarray(s[pi], np.int32)
                ins[oi] = np.asarray(i[pi], np.int32)
        return np.stack(pts), np.stack(sem), np.stack(ins)

    def sample_batch(self, rng: np.random.Generator, batch: int) -> dict:
        idx = rng.integers(0, len(self), batch)
        pts, sem, ins = self._read_rows(idx)
        n = pts.shape[1]
        if n >= self.num_points:
            cols = rng.choice(n, self.num_points, replace=False)
            pts, sem, ins = pts[:, cols], sem[:, cols], ins[:, cols]
        else:
            reps = rng.integers(0, n, self.num_points - n)
            pts = np.concatenate([pts, pts[:, reps]], axis=1)
            sem = np.concatenate([sem, sem[:, reps]], axis=1)
            ins = np.concatenate([ins, ins[:, reps]], axis=1)
        # normalize ids: instances 1..K (0 = unassigned), semantics 1..C
        # (PartNet ins_seg labels are 0-BASED part classes with -1 =
        # unlabeled; the eval protocol treats sem<=0 as void, so class 0
        # must shift to 1 like instances do, or its GT could never be
        # matched and its AP would pin at 0)
        ins = np.where(ins >= 0, ins + 1, 0).astype(np.int32)
        sem = np.where(sem >= 0, sem + 1, 0).astype(np.int32)
        b, npts = pts.shape[0], pts.shape[1]
        return {
            "xyz": pts.astype(np.float32),
            "features": np.zeros((b, npts, 0), np.float32),
            "valid": np.ones((b, npts), bool),
            "sem_label": sem,
            "inst_label": ins,
        }
