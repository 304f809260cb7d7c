"""Output-file naming: the reference's deterministic stem-extension scheme
(``imageop.h:99-108`` + ``oipshared.h:56-64``).

Copied from ``opticalimageprocessor_tpu/formats/naming.py``
(``build_output_file_path`` only).
"""

from __future__ import annotations

import os


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
