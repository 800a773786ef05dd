"""Device resolution, the CUDA kernel build, and launch counters.

Device policy (one source of truth for the whole port): entry points take
an explicit ``device``.  ``None`` means the card — and with no CUDA device
present that raises instead of falling back.  ``"cpu"`` runs every kernel's
plain torch version (kernels/ref.py); nothing else ever reaches it.  Kernel
wrappers decide by the device of the tensors they are handed: a CPU tensor
takes the plain version, a CUDA tensor launches the hand-written kernel
(and raises if it cannot), any other device raises.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/*.cu`` with a plain C
interface.  :func:`library` compiles them at first use — one ``nvcc`` per
source, all started together, then one link — into a shared library under
``_build/`` beside this file (a directory git ignores), keyed by a hash of
the sources and flags so an edited source is rebuilt, and loads it with
ctypes.  Nothing is built from outside the package.

Every launch path counts its launches on a :class:`LaunchCounter`, so a
caller can show that a run really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(0, (max(int(x), 1) - 1).bit_length())


def floor_pow2(x: int) -> int:
    """Largest power of two <= max(x, 1)."""
    return 1 << (max(int(x), 1).bit_length() - 1)


# ----------------------------------------------------------------------- #
# Devices                                                                  #
# ----------------------------------------------------------------------- #
def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for (explicitly or by
    default) and there is none — the port never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        # "cuda" names the current card: give it its index, so that it
        # compares equal to the device of the tensors made there and keys
        # one memo entry per card
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected 'cpu' or 'cuda'")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel path), False for a CPU tensor (plain
    path); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} are not supported")


_HOPPER_OK: Dict[int, bool] = {}


def require_hopper(dev: torch.device) -> None:
    """The kernels are built for sm_90a only: refuse any other card."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _HOPPER_OK:
        _HOPPER_OK[idx] = torch.cuda.get_device_capability(idx) == (9, 0)
    if not _HOPPER_OK[idx]:
        cap = torch.cuda.get_device_capability(idx)
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"device {idx} is sm_{cap[0]}{cap[1]}")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: Sequence[int], dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev`` — what a kernel takes; it checks nothing itself."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ----------------------------------------------------------------------- #
# Launch counters                                                          #
# ----------------------------------------------------------------------- #
class LaunchCounter:
    """Plain integer count of one kernel's launches."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def inc(self) -> None:
        self.count += 1


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The process-wide counter of kernel ``name`` (created on first use)."""
    return _COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in sorted(_COUNTERS.items())}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.count = 0


# ----------------------------------------------------------------------- #
# Build and load                                                           #
# ----------------------------------------------------------------------- #
def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (no-op when the
    library for these exact sources exists).  One ``nvcc`` per source runs
    in parallel; the link writes to a temporary name that is renamed into
    place, so concurrent builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def kernel_fn(symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (pointers and the stream as ``c_void_p``; every entry point returns the
    ``cudaError_t`` of its launch as an int).  Memoized per symbol."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(library(), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def check_launch(err: int, name: str) -> None:
    """Raise if a launch was refused (a refused launch never runs, and a
    later synchronize would not report it)."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def stream_ptr(dev: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``dev``, a CUDA tensor's
    device (read through the binding PyTorch's own generated code uses,
    which skips building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)
