# One module per assigned architecture (exact public-literature configs)
# plus base.py (registry + input specs); the port's copies of the JAX
# package's ``configs/``.  CLI ids use the assignment spelling
# ("--arch yi-9b"); module names are import-safe.
from .base import ARCH_IDS, ALIASES, get_config, input_specs, shape_supported
