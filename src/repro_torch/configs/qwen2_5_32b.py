"""--arch config module (see archs.py for the exact numbers)."""
from .archs import QWEN2_5_32B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
