"""--arch config module (see archs.py for the exact numbers)."""
from .archs import WHISPER_TINY as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
