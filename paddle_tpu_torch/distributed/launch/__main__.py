import sys

from . import launch

sys.exit(launch())
