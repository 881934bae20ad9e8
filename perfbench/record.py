"""What one run hands to the metric readers (`metrics/<metric>.py`).

A reader is a module with `read(rec) -> float | None`: None where the run
has nothing for it to read (an untraced run for a per-layer metric, a trace
with no device op), and the harness then leaves the metric out of the line.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Call:
    input: int                # index into the workload's inputs
    rows: int                 # pairs scored, every row of the call
    wall_s: float             # host clock, call to returned numpy scores
    run_metrics: object = None  # strsim_tpu_torch RunMetrics, traced runs only
    failed: bool = False


@dataclasses.dataclass
class Record:
    workload: object          # loadgen.Workload
    setup_s: float
    window_s: float           # first call's start to the last call's return
    calls: List[Call]
    trace: Optional[object] = None  # trace.Trace: traced runs on a card, and untraced
                                    # ones of a cell with an end-to-end metric from the trace
    peaks: Optional[dict] = None    # roofline/_peaks.py's entry for the card

    def done(self) -> List[Call]:
        return [c for c in self.calls if not c.failed]

    def phased(self) -> List[Call]:
        """Calls of a traced run, with their RunMetrics."""
        return [c for c in self.done() if c.run_metrics is not None]
