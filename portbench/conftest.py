"""The benchmark's own CPU tests: ``python -m pytest portbench -q``."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the port's logger would otherwise append to oip.log in the working
# directory
os.environ.setdefault("LOGFILE", os.devnull)
