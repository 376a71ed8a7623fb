"""--arch config module (see archs.py for the exact numbers)."""
from .archs import GROK_1_314B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
