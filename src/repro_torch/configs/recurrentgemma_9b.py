"""--arch config module (see archs.py for the exact numbers)."""
from .archs import RECURRENTGEMMA_9B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
