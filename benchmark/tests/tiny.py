"""A cell cut to a CPU-sized grid, for the benchmark's own tests."""

from __future__ import annotations

import copy

from benchmark.harness.cells import benchmark_json, from_files, resolve

TINY_ROI = {"z": [-1.0875, 1.8125], "y": [-1.25625, 1.25625], "x": [0.7703125, 2.2203125]}


def tiny(name: str, frames: int = 8):
    """The cell ``name`` on an (8, 16, 32) grid with ``frames`` frames and
    few steps: widths, depth and code path as the cell's."""
    if name in {w["name"] for w in benchmark_json()["workloads"]}:
        cell = resolve(name)
    else:   # a cell kept as files for a later benchmark change
        config, traffic = name.split(".")
        cell = from_files(name, f"benchmark/configs/{config}.json", traffic)
    return shrink(cell, frames)


def shrink(cell, frames: int = 8):
    """``cell`` cut to the tiny grid in place (and returned)."""
    cell.cfg = copy.deepcopy(cell.cfg)
    ds = cell.cfg["DATASET"]
    ds["ROI"][ds["RDR_CUBE"]["ROI_TYPE"]] = dict(TINY_ROI)
    cell.cfg["test_cfg"]["pc_range"] = [TINY_ROI[a][0] for a in "xyz"]
    cell.traffic = copy.deepcopy(cell.traffic)
    tr = cell.traffic
    tr["frames"] = frames
    tr["pose"]["margin_vox_zyx"] = [2, 3, 6]
    if tr["kind"] == "train_loop":
        tr["batch_per_rank"] = min(tr["batch_per_rank"], 2)
        tr["warm_steps"] = 3
        tr["trace"] = {"after": 0, "count": 1}
    else:
        tr["warm_frames"] = 2
        tr["check_frames"] = 3
        tr["trace"] = {"after": 1, "count": 2}
    return cell
