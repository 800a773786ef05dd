"""Host tooling: the roofline inputs PyTorch records (``hlo_analysis``)."""

from . import hlo_analysis  # noqa: F401
