"""--arch config module (see archs.py for the exact numbers)."""
from .archs import INTERNVL2_26B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
