"""Cityscapes file/IO helpers. Port of ``fcn8s_tensorflow_tpu/utils/cs_helpers.py``,
a copy.

The reference's ``cityscapesscripts/helpers/csHelpers.py``:
filename parsing (`city_sequence_frame_type[_type2].ext`), core-name
extraction, path/JSON utilities, and the ANSI score colorizer used by the
terminal evaluation reports.
"""

from __future__ import annotations

import json
import os
from collections import namedtuple

CsFile = namedtuple("CsFile", ["city", "sequenceNb", "frameNb", "type", "type2", "ext"])


class colors:  # noqa: N801 — name parity with the reference helper
    RED = "\033[31;1m"
    GREEN = "\033[32;1m"
    YELLOW = "\033[33;1m"
    BLUE = "\033[34;1m"
    MAGENTA = "\033[35;1m"
    CYAN = "\033[36;1m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"
    ENDC = "\033[0m"


def print_error(message: str) -> None:
    """Print a colorized ERROR and raise (the reference sys.exit()s;
    raising is library-friendly while CLI mains catch and exit)."""
    raise RuntimeError(f"ERROR: {message}")


def get_color_entry(val, args):
    """Map a [0,1] score to an ANSI color (reference csHelpers.py:56-76)."""
    if not getattr(args, "colorized", False):
        return ""
    if not isinstance(val, (float, int)) or val != val:  # NaN
        return colors.ENDC
    if val < 0.20:
        return colors.RED
    if val < 0.40:
        return colors.YELLOW
    if val < 0.60:
        return colors.BLUE
    if val < 0.80:
        return colors.CYAN
    return colors.GREEN


def get_cs_file_info(file_name: str) -> CsFile:
    """Parse a Cityscapes filename into its parts (reference `:82-98`):
    ``{city}_{seq:06}_{frame:06}_{type}[_{type2}].{ext}`` — city may itself
    contain underscores."""
    base = os.path.basename(file_name)
    stem, ext = os.path.splitext(base)
    parts = stem.split("_")
    if len(parts) < 4:
        raise ValueError(f"Cannot parse Cityscapes filename: {file_name}")
    # sequence and frame are the two 6-digit numeric fields; find them from
    # the right so multi-underscore city names survive.
    numeric = [i for i, p in enumerate(parts) if p.isdigit() and len(p) == 6]
    if len(numeric) < 2:
        raise ValueError(f"Cannot parse Cityscapes filename: {file_name}")
    seq_i, frame_i = numeric[0], numeric[1]
    city = "_".join(parts[:seq_i])
    type_ = parts[frame_i + 1] if frame_i + 1 < len(parts) else ""
    type2 = "_".join(parts[frame_i + 2 :]) if frame_i + 2 < len(parts) else ""
    return CsFile(city, parts[seq_i], parts[frame_i], type_, type2, ext.lstrip("."))


def get_core_image_file_name(file_name: str) -> str:
    """``{city}_{seq}_{frame}`` (reference `:102-104`)."""
    info = get_cs_file_info(file_name)
    return f"{info.city}_{info.sequenceNb}_{info.frameNb}"


def ensure_path(path: str) -> None:
    """mkdir -p (reference `:115-119`)."""
    if path:
        os.makedirs(path, exist_ok=True)


def write_dict_to_json(dict_obj: dict, file_name: str) -> None:
    """Pretty-printed JSON export (reference `:122-124`)."""
    ensure_path(os.path.dirname(file_name))
    with open(file_name, "w") as f:
        json.dump(dict_obj, f, indent=4, sort_keys=True, default=float)
