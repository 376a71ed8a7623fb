"""--arch config module (see archs.py for the exact numbers)."""
from .archs import DEEPSEEK_MOE_16B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
