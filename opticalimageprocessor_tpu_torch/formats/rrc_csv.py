"""Relative Radiometric Correction parameter file (CSV) reader.

File layout (reference ``imageop.h:140-192``):

    line 1: ``1``            (format marker)
    line 2: ``<N>``          (number of parameter rows == detector columns)
    line 3: ``0``            (format marker)
    lines 4..3+N: ``k , b``  (per-detector-column linear gain/bias, doubles)

Copied from ``opticalimageprocessor_tpu/formats/rrc_csv.py``
(``load_rrc_params`` and its error type only).
"""

from __future__ import annotations

import numpy as np


class RRCParamError(ValueError):
    pass


def load_rrc_params(path: str, expected_columns: int) -> np.ndarray:
    """Load per-column (k, b) gain/bias pairs.

    Returns a float64 array of shape ``(expected_columns, 2)``: ``[:, 0]`` is
    the gain *k*, ``[:, 1]`` the bias *b*.

    Raises :class:`RRCParamError` on any of the invariants the reference
    enforces (header line-count mismatch, malformed row, row-count mismatch).
    """
    with open(path, "rb") as f:
        raw = f.read().decode("ascii", errors="replace")
    lines = raw.splitlines()
    if len(lines) < 3:
        raise RRCParamError(f"RRC param file [{path}] truncated header")
    # Header markers "1" / "0" are only assert()ed in the reference (DEBUG
    # builds, imageop.h:150-153,165-169); tolerated like release builds.
    try:
        declared = int(lines[1].strip() or "0")
    except ValueError:
        raise RRCParamError(
            f"RRC param file [{path}] line 2 is not a line count: {lines[1]!r}"
        )
    if declared != expected_columns:
        raise RRCParamError(
            f"RRC param file [{path}]: expected {expected_columns} lines, "
            f"{declared} found in file content"
        )

    rows = []
    for i, ln in enumerate(lines[3:]):
        if ln.strip() == "" and i >= declared:
            continue  # trailing blank lines
        parts = ln.split(",")
        if len(parts) != 2:
            raise RRCParamError(
                f"line #{i} of RRC param file [{path}] found invalid: {ln!r}"
            )
        try:
            k = float(parts[0])
            b = float(parts[1])
        except ValueError:
            raise RRCParamError(
                f"line #{i} of RRC param file [{path}] found invalid: {ln!r}"
            )
        rows.append((k, b))

    if len(rows) != expected_columns:
        raise RRCParamError(
            f"RRC Param file [{path}] invalid: {expected_columns} lines of "
            f"param expected, {len(rows)} lines parsed."
        )
    return np.asarray(rows, dtype=np.float64)
