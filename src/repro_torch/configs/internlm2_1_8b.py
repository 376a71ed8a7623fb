"""--arch config module (see archs.py for the exact numbers)."""
from .archs import INTERNLM2_1_8B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
