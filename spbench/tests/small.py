"""The cells at a size a test holds: each configuration's arguments
with its ``small`` ones laid over them (the shapes kept: 8-wide stripes
of 8 blocks; a cube of the stencil above auto-RCM's 1,024-row threshold)."""

from __future__ import annotations

from spbench import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def small_cell(name: str, trace: bool = False) -> harness.Cell:
    cell = harness.cell_of(harness.load_manifest(), name, trace)
    cell.config["args"].update(cell.config["small"])
    return cell
