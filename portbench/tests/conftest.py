"""The harness's own tests, on the CPU: `python -m pytest portbench/tests`.

They put `portbench/` (the harness's modules and run.py) and the
repository root on the import path, as `python3 portbench/run.py` has them.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
