"""--arch config module (see archs.py for the exact numbers)."""
from .archs import MAMBA2_2_7B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
