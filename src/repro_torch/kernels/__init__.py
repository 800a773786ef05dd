# Hand-written CUDA kernels (csrc/*.cu, sm_90a) for the packed engine's hot
# spots, each the port of one Pallas TPU kernel of the JAX package:
#   propagate_batched.py — one masked ELL frontier round (delta + seen)
#   propagate_fused.py   — the whole ELL frontier loop in one launch
#   propagate_vector.py  — one vector-payload (per-file) ELL round
#   bincount.py          — weighted histogram (global result update)
#   propagate.py         — ELL gather row sums of one corpus
#   rank_files.py        — each word's files ranked by count (no Pallas
#                          kernel: the JAX package's jnp.argsort)
# ops.py: device-routed wrappers + ELL-vs-segment_sum predicates;
# ref.py: plain torch versions (the CPU path and the kernels' oracles);
# _common.py: device policy, the nvcc build, launch counters.
from . import ops, ref  # noqa: F401
from ._common import (build_library, launch_counts,  # noqa: F401
                      reset_launch_counts, resolve_device)
