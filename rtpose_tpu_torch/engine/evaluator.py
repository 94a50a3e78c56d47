"""Evaluation / inference loop with the reference's throughput harness.

Counterpart of ``rtpose_tpu/engine/evaluator.py`` (reference
``tools/test.py:178-252``): iterate the eval loader, decode on the device,
accumulate detections keyed ``seq/frame/rdr_frame``, time the middle third
of the batches with ``torch.cuda.synchronize()`` at the window edges, and
hand the dict to ``dataset.evaluation``.  Under a process group each rank
evaluates its shard of the frames and the detections of every rank are
gathered and merged by key (``rtpose_tpu/engine/evaluator.py:134-137``).

``counts()``: ``h2d_bytes``, the input bytes ``device_prefetch`` copied to
the card since the last ``reset()`` (none on the CPU, where nothing is
copied).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import parallel
from ..core.decode import post_process_pose, post_process_pose_multi
from ..utils import trace

_COUNTS = dict(h2d_bytes=0)
_COUNTS_LOCK = threading.Lock()     # the prefetch workers add, other threads read


def counts() -> dict:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def device_prefetch(loader, device: torch.device, depth: int = 2) -> Iterator[dict]:
    """Double-buffered host -> device transfer.

    A background thread pulls host batches, copies their arrays into pinned
    memory and issues the non-blocking H2D copies on a side stream, so the
    copy of batch k+1 overlaps batch k's compute.  The consumer's stream
    waits on each batch's copy event before using it.  'meta'/'valid' stay
    on the host.  On the CPU the arrays are wrapped without a copy.
    """
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for hb in loader:
                dev, event = {}, None
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        for k, v in hb.items():
                            if k not in ("meta", "valid"):
                                pinned = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                                dev[k] = pinned.to(device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(copy_stream)
                    with _COUNTS_LOCK:
                        _COUNTS["h2d_bytes"] += sum(t.nbytes for t in dev.values())
                else:
                    dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in hb.items() if k not in ("meta", "valid")}
                if not put((hb, dev, event)):
                    return
        except Exception as e:  # handed to the consumer, which re-raises it
            err.append(e)
        finally:
            put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise err[0]
                return
            hb, dev, event = item
            if event is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(event)
                for v in dev.values():
                    v.record_stream(cur)
            out = dict(dev)
            out["meta"] = hb.get("meta")
            out["valid"] = hb.get("valid")
            yield out
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()


def run_eval(eval_step: Callable, loader, decode_spec, *, device: torch.device,
             one_hm: bool = True, speed_test: bool = False,
             logger=None) -> Tuple[Dict[str, dict], Optional[float]]:
    """Returns (detections, seconds_per_frame or None).  A task's outputs
    are (kpts, scores, labels), or (kpts, scores) from the multi-person
    decode (``post_process_pose_multi``).

    The timed window covers host load + H2D + forward/decode + host
    post-processing of the middle third of the batches — the end-to-end
    per-frame cost the reference times with cuda.synchronize
    (tools/test.py:186-201).  The time is this rank's, over its own frames.

    Under a process group the detections are every rank's, gathered and
    merged by key (also at world size 1), so the loader's wrap-around
    padding, which repeats frames across the ranks, adds none.  They merge
    in the order of the unshuffled strided shards (rank r's i-th frame
    before rank r + 1's), which is the dataset's own order, so the
    evaluation sums in the order of a one-process run."""
    cuda = device.type == "cuda"
    detections: Dict[str, dict] = {}
    n_batches = len(loader)
    start_i, end_i = n_batches // 3, (2 * n_batches) // 3
    t_start = t_end = None
    frames_timed = 0

    batches = device_prefetch(loader, device)
    try:
        for i in itertools.count():
            with trace.span("eval.next_batch"):
                batch = next(batches, None)
            if batch is None:
                break
            if speed_test and i in (start_i, end_i):
                if cuda:
                    torch.cuda.synchronize(device)
                if i == start_i:
                    t_start = time.perf_counter()
                else:
                    t_end = time.perf_counter()
            valid = int(batch["valid"])
            if speed_test and start_i <= i < end_i:
                frames_timed += valid
            with trace.span("eval.step"):
                per_task = eval_step({k: v for k, v in batch.items()
                                      if k not in ("meta", "valid")})
            metas = batch["meta"][:valid]
            # every task's outputs to the host with one wait: non-blocking
            # copies into pinned memory, then one stream synchronize
            with trace.span("eval.sync"):
                per_task = [[t[:valid].to("cpu", non_blocking=cuda) for t in outs]
                            for outs in per_task]
                if cuda:
                    torch.cuda.current_stream(device).synchronize()
            with trace.span("eval.post"):
                merged = None
                for outs in per_task:
                    if len(outs) == 2:          # the multi-person decode
                        kpts, scores = outs
                        outs = post_process_pose_multi(kpts.numpy(), scores.numpy(),
                                                       decode_spec, metas=metas)
                    else:
                        kpts, scores, labels = outs
                        outs = post_process_pose(kpts.numpy(), scores.numpy(), labels.numpy(),
                                                 decode_spec, metas=metas, one_hm=one_hm)
                    if merged is None:
                        merged = outs
                    else:
                        for m, o in zip(merged, outs):
                            m["keypoints"] += o["keypoints"]
                for out in merged:
                    meta = out.pop("metadata")
                    detections[f"{meta['seq']}/{meta['frame']}/{meta['rdr_frame']}"] = out
    finally:
        batches.close()

    sec_per_frame = None
    if speed_test and t_start is not None and t_end is not None and frames_timed:
        sec_per_frame = (t_end - t_start) / frames_timed
        if logger:
            logger.info(f"Total time per frame: {sec_per_frame:.6f}s "
                        f"({1.0 / sec_per_frame:.1f} frames/s)")
    if parallel.is_distributed():
        parts = [list(p.items()) for p in parallel.all_gather_objects(detections)]
        detections = {}
        for i in range(max(len(p) for p in parts)):
            for p in parts:
                if i < len(p):
                    detections.setdefault(*p[i])
    return detections, sec_per_frame


def save_predictions(detections: Dict[str, dict], work_dir: str,
                     checkpoint_name: str, split: str) -> str:
    """Write {split}_prediction.json (tools/test.py:41-63 format)."""
    result: Dict[str, dict] = {}
    for key, val in detections.items():
        seq, frame, rdr_frame = key.split("/")
        result.setdefault(seq, {})[frame] = {
            "keypoints": [list(p) for p in val["keypoints"]],
            "rdr_frame": rdr_frame,
        }
    for seq in result:
        result[seq] = dict(sorted(result[seq].items(), key=lambda x: x[0]))
    out_dir = os.path.join(work_dir, checkpoint_name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{split}_prediction.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path
