"""Output-file naming: the reference's deterministic stem-extension scheme
(``imageop.h:99-108`` + ``oipshared.h:56-64``), and the station, satellite
and timestamp that name an AOS downlink file.

Copied from ``opticalimageprocessor_tpu/formats/naming.py``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass


def build_output_file_path(
    template_path: str,
    stem_extension: str,
    replace_extension: str | None = None,
    out_dir: str | None = None,
) -> str:
    """``BuildOutputFilePath`` (imageop.h:99-108).

    ``<out_dir or cwd>/<stem of template><stem_extension><extension>`` where
    extension is the template's own unless ``replace_extension`` is given.
    """
    base = os.path.basename(template_path)
    stem, ext = os.path.splitext(base)
    ext = replace_extension if replace_extension is not None else ext
    directory = out_dir if out_dir is not None else os.getcwd()
    return os.path.join(directory, stem + stem_extension + ext)


@dataclass
class AosFileInfo:
    """Station/satellite/timestamp parsed from an AOS file or directory name
    (reference ``AosFileInfo`` struct, aux_separator.h:142-151, parsed by
    ``ParseFileInfoFromName`` at aux_separator.h:692-719)."""

    station: str = ""
    satellite: str = ""
    year: int = 0
    month: int = 0
    day: int = 0
    hour: int = 0
    minute: int = 0
    second: int = 0


_AOS_NAME_RE = re.compile(
    r"^([A-Za-z0-9]{1,15})[_-]+([A-Za-z0-9-]{1,15})"
    r"_(\d{4})(\d{2})(\d{2})_(\d{2})(\d{2})(\d{2})_(\d+)"
)


def parse_aos_file_info(name: str) -> AosFileInfo | None:
    """Parse ``<station>_<satellite>_<YYYYMMDD>_<hhmmss>_<n>`` names.

    Mirrors the scanf pattern at aux_separator.h:700-706; returns None when
    the pattern does not match (caller then tries the parent directory name,
    aux_separator.h:208-213).
    """
    m = _AOS_NAME_RE.match(name)
    if not m:
        return None
    st, sat, y, mo, d, h, mi, s, _cmos = m.groups()
    return AosFileInfo(
        station=st,
        satellite=sat,
        year=int(y),
        month=int(mo),
        day=int(d),
        hour=int(h),
        minute=int(mi),
        second=int(s),
    )


def imdt_file_name(afi: AosFileInfo, cmos1: bool) -> str:
    """IMDT intermediate-file name (aux_separator.h:513-523)."""
    return (
        f"{afi.station}_{afi.satellite}_{'CMOS-1' if cmos1 else 'CMOS-2'}_"
        f"{afi.year:04d}{afi.month:02d}{afi.day:02d}_"
        f"{afi.hour:02d}{afi.minute:02d}{afi.second:02d}.IMDT"
    )
