"""--arch config module (see archs.py for the exact numbers)."""
from .archs import COMMAND_R_35B as CONFIG
from .archs import reduced

SMOKE = reduced(CONFIG)
