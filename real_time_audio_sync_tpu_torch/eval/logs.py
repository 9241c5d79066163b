"""Field-test log record/replay.

The live apps append every committed path pair to
``tests/<alg>_test_live_<unix_ts>.txt`` with a 5-line parameter header
(livenote_live.py:138-143,153-154; wtw_live.py:169-174,208-210), and the WTW
app's 'e' key appends four accuracy-summary lines (wtw_live.py:299-307).
``tests.py:20-27`` replays such logs by skipping the 5 header lines and
parsing ``"live ref"`` integer pairs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

FIELD_LOG_HEADER_LINES = 5


@dataclasses.dataclass
class FieldLog:
    header: List[str]  # the 5 header lines, stripped
    path: List[Tuple[int, int]]
    summary: List[str]  # trailing non-numeric lines (WTW accuracy summaries)

    @property
    def reference_recording(self) -> str:
        return self.header[0] if self.header else ""

    def params(self) -> dict:
        """Parse the ``key: value`` header lines."""
        out = {}
        for line in self.header[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = int(v.strip())
        return out


def parse_field_log(path: str) -> FieldLog:
    with open(path) as f:
        lines = [line.strip() for line in f.readlines()]
    header = lines[:FIELD_LOG_HEADER_LINES]
    pairs: List[Tuple[int, int]] = []
    summary: List[str] = []
    for line in lines[FIELD_LOG_HEADER_LINES:]:
        if not line:
            continue
        tokens = line.split(" ")
        if len(tokens) == 2 and tokens[0].lstrip("-").isdigit() and tokens[1].lstrip("-").isdigit():
            pairs.append((int(tokens[0]), int(tokens[1])))
        else:
            summary.append(line)
    return FieldLog(header, pairs, summary)


def path_from_field_log(path: str) -> List[Tuple[int, int]]:
    """``data_from_file`` parity (tests.py:20-27): path pairs only."""
    return parse_field_log(path).path


def parse_summary_percentages(summary_lines: Sequence[str]) -> List[float]:
    """Extract the percentages from WTW accuracy-summary lines, e.g.
    ``Percent incorrect (within 1 beat):4.04494382022%``."""
    out = []
    for line in summary_lines:
        if ":" in line and line.endswith("%"):
            out.append(float(line.rsplit(":", 1)[1].rstrip("%")))
    return out


def write_field_log(
    out_path: str,
    reference_recording: str,
    params: Sequence[Tuple[str, int]],
    path: Sequence[Tuple[int, int]],
    summary: Sequence[str] = (),
) -> None:
    """Write a log byte-compatible with the reference format (``\\r\\n``
    line endings, ``%d %d`` pairs)."""
    if len(params) != FIELD_LOG_HEADER_LINES - 1:
        raise ValueError("field log header takes exactly 4 param lines")
    with open(out_path, "w", newline="") as f:
        f.write("%s\r\n" % reference_recording)
        for k, v in params:
            f.write("%s: %d\r\n" % (k, v))
        for l, r in path:
            f.write("%d %d\r\n" % (l, r))
        for line in summary:
            f.write("%s\r\n" % line)
