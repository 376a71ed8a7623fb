"""--arch config module (see archs.py for the exact numbers)."""
from .archs import GEMMA3_1B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
