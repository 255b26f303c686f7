"""What a run of one cell shares with its driver, its traffic and its
metric readers, and how each piece is found by name.

A cell ``perfbench/workloads/<cell>.json`` names its configuration
(``perfbench/configs/<config>.json``), its driver
(``perfbench/drivers/<driver>.py``), its traffic generator
(``perfbench/traffic/<generator>.py``) and the limits of its output
checks. A metric ``<metric>`` of ``BENCHMARK.json`` is read by
``perfbench/metrics/<metric>.py``, whose ``read(run)`` returns a number,
or None where the run holds nothing for it to read. Adding a cell, a
generator or a metric adds files and ``BENCHMARK.json`` entries and
edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from perfbench.spans import Recorder

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def piece(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py`` (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones with ``trace`` off, the per-layer ones with it on; an entry with
    ``workloads`` only in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the driver leaves for the
    readers."""
    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    rec: Recorder = dataclasses.field(default_factory=Recorder)
    setup_s: float = 0.0
    t_start: float = 0.0         # the window, on the recorder's clock
    t_end: float = 0.0
    traced: object = None        # trace.DeviceTrace of the traced stretch
    traced_until: float = 0.0    # host time the traced stretch ended
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0

    def check(self, name: str, value: float) -> None:
        """Record an output check beside its limit from the cell file."""
        self.checks[name] = {"value": float(value),
                             "limit": float(self.cell["limits"][name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())

    @property
    def steady_from(self) -> float:
        """Where host-clock readings of a traced run start: after the
        traced stretch (the whole window in an untraced run)."""
        return max(self.t_start, self.traced_until)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile of all ``values``, linearly interpolated
    between order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
