"""GT-database copy-paste augmentation (LiDAR).

A copy of ``rtpose_tpu/data/gt_sampler.py`` (numpy only).  Parity surface
for the reference's ``create_gt_database``
(``det3d/datasets/utils/create_gt_database.py``) and ``DataBaseSamplerV2``
(``det3d/core/sampler/sample_ops.py:13-369``): build a database of
per-object point clusters from annotated scenes, then paste sampled objects
into training scenes with box-collision rejection.

Host-side numpy (augmentation happens in the data pipeline before padding
to fixed shapes).  Collision testing uses axis-aligned-expanded BEV IoU —
simpler than the reference's numba rotated-collision kernel but
conservative (never under-rejects).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List, Optional

import numpy as np


def points_in_box_np(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """(N, >=3) points inside a (7,) rotated box -> bool mask."""
    local = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = local[:, 0] * c - local[:, 1] * s
    ly = local[:, 0] * s + local[:, 1] * c
    return ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
            & (np.abs(local[:, 2]) <= box[5] / 2))


def create_gt_database(samples: List[dict], out_path: Optional[str] = None
                       ) -> Dict[str, List[dict]]:
    """Extract per-object point clusters.

    samples: [{'points': (N, F), 'gt_boxes': (M, 7), 'gt_names': [str]*M}]
    Returns {class_name: [{'points': local points, 'box': box}]}.
    """
    db: Dict[str, List[dict]] = {}
    for s in samples:
        pts = np.asarray(s["points"], np.float32)
        for box, name in zip(np.asarray(s["gt_boxes"], np.float32),
                             s["gt_names"]):
            mask = points_in_box_np(pts, box)
            obj = pts[mask].copy()
            obj[:, :3] -= box[:3]            # store object-local points
            db.setdefault(name, []).append(dict(points=obj, box=box.copy()))
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(db, f)
    return db


def _aabb(boxes: np.ndarray) -> np.ndarray:
    """Conservative axis-aligned BEV bounds of rotated boxes (N, 4)."""
    half = 0.5 * np.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    return np.stack([boxes[:, 0] - half, boxes[:, 1] - half,
                     boxes[:, 0] + half, boxes[:, 1] + half], axis=1)


class DataBaseSampler:
    """Sample objects from a GT database and paste them into a scene."""

    def __init__(self, db: Dict[str, List[dict]] | str,
                 sample_groups: Dict[str, int], rng=None):
        if isinstance(db, str):
            with open(db, "rb") as f:
                db = pickle.load(f)
        self.db = db
        self.sample_groups = dict(sample_groups)
        self.rng = rng or np.random.default_rng(0)
        # BatchLoader worker threads share this sampler; Generator state is
        # not thread-safe, so draws are serialized (draws are tiny vs the
        # per-sample decode work)
        self._lock = threading.Lock()

    def sample_all(self, points: np.ndarray, gt_boxes: np.ndarray,
                   gt_names: List[str]):
        """Returns (points, gt_boxes, gt_names) with pasted objects.

        Each candidate is rejected if its (conservative AABB) footprint
        intersects any existing or previously-accepted box.
        """
        points = np.asarray(points, np.float32)
        boxes = list(np.asarray(gt_boxes, np.float32))
        names = list(gt_names)
        occupied = _aabb(np.asarray(boxes)) if boxes else np.zeros((0, 4))

        added_pts = []
        for cls, want in self.sample_groups.items():
            pool = self.db.get(cls, [])
            if not pool:
                continue
            need = max(0, want - sum(n == cls for n in names))
            with self._lock:
                picks = self.rng.choice(len(pool), size=min(need, len(pool)),
                                        replace=False)
            for pi in np.atleast_1d(picks):
                cand = pool[int(pi)]
                box = cand["box"].copy()
                bb = _aabb(box[None])[0]
                if len(occupied) and np.any(
                        (bb[0] < occupied[:, 2]) & (bb[2] > occupied[:, 0])
                        & (bb[1] < occupied[:, 3]) & (bb[3] > occupied[:, 1])):
                    continue  # collision -> reject
                obj = cand["points"].copy()
                obj[:, :3] += box[:3]
                added_pts.append(obj)
                boxes.append(box)
                names.append(cls)
                occupied = np.concatenate([occupied, bb[None]]) if len(occupied) \
                    else bb[None]
        if added_pts:
            points = np.concatenate([points, *added_pts], axis=0)
        return points, np.asarray(boxes, np.float32), names
