"""Progress reporting.

Reference: src/report.rs.  ``WriteReporter`` reproduces the reference's text
protocol (``Checking. states=… unique=… depth=…`` / ``Done. … sec=…`` /
``Discovered "name" example Path[n]: …`` + ``Fingerprint path: a/b/c``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, TextIO


@dataclass
class ReportData:
    total_states: int
    unique_states: int
    max_depth: int
    duration: float  # seconds
    done: bool


@dataclass
class ReportDiscovery:
    path: "Path"
    classification: str  # "example" | "counterexample"


class Reporter:
    def report_checking(self, data: ReportData) -> None:
        raise NotImplementedError

    def report_discoveries(self, model, discoveries: Dict[str, ReportDiscovery]) -> None:
        raise NotImplementedError

    def delay(self) -> float:
        return 1.0


class WriteReporter(Reporter):
    def __init__(self, writer: TextIO, delay: float = 1.0):
        self._writer = writer
        self._delay = delay

    def delay(self) -> float:
        return self._delay

    def report_checking(self, data: ReportData) -> None:
        if data.done:
            self._writer.write(
                f"Done. states={data.total_states}, unique={data.unique_states}, "
                f"depth={data.max_depth}, sec={int(data.duration)}\n"
            )
        else:
            self._writer.write(
                f"Checking. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}\n"
            )

    def report_discoveries(self, model, discoveries: Dict[str, ReportDiscovery]) -> None:
        for name in sorted(discoveries):
            d = discoveries[name]
            self._writer.write(f'Discovered "{name}" {d.classification} {d.path}')
            self._writer.write(f"Fingerprint path: {d.path.encode(model)}\n")
