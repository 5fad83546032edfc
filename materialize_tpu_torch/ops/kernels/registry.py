"""Kernel dispatch for the port: by device, with no fallback on the card.

Each hot-path primitive that the JAX package wrote in Pallas has, in this
package, a CUDA C++ kernel for sm_90a (`materialize_tpu_torch/csrc/*.cu`)
and a plain PyTorch version of the same function beside its wrapper:

- a call whose tensors lie on the CPU runs the plain version;
- a call whose tensors lie on a CUDA device launches the kernel, or raises.

There is no mode switch. Each kernel has a launch counter, a plain integer
in `LAUNCHES` that its wrapper bumps once per call that launches the kernel
(a wrapper call may issue several CUDA launches; it counts once). Workers of
a mesh launch from their own threads, so the counters are bumped under a
lock. A launch runs with the tensors' device as the thread's current device,
on that device's current stream (`on_device`).

The kernels are built at first use: every source in `csrc/` is compiled by
`nvcc` into its own shared library with a plain C interface, all sources at
once in parallel, into `materialize_tpu_torch/_build/`, and loaded with
ctypes. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

KERNELS = ("run_sum", "multi_take", "probe", "probe2", "route_dest", "bucket_rank")
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
_COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points of csrc/*.cu: (argtypes, restype). Pointers and the stream
# are c_void_p, or ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "mz_probe": ((_VP, _I64, _VP, _I64, _INT, _VP, _VP), _INT),
    "mz_probe2": ((_VP, _VP, _I64, _VP, _VP, _I64, _INT, _VP, _VP), _INT),
    "mz_take_max_cols": ((), _INT),
    "mz_multi_take": ((_VP, _VP, _INT, _INT, _VP, _I64, _I64, _VP), _INT),
    "mz_run_sum_scratch_bytes": ((_I64, _INT), _I64),
    "mz_run_sum": ((_VP, _VP, _I64, _INT, _VP, _VP, _VP), _INT),
    "mz_route_dest": ((_VP, _I64, _INT, _VP, _VP), _INT),
    "mz_bucket_rank_scratch_bytes": ((_I64,), _I64),
    "mz_bucket_rank": ((_VP, _I64, _VP, _VP, _VP), _INT),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc's output (registers, spills)
BUILD_SECONDS: float | None = None


# When a dict, `launch` also keeps per kernel the shapes of its calls and
# the arguments of its largest call, so a run can replay the main path's
# real inputs (chip_smoke.py). None keeps nothing.
SAMPLES: dict | None = None


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch(name: str, args: tuple, shape: tuple) -> None:
    """Count one launch of kernel `name`; called by its wrapper just before
    the kernel is launched, and nowhere else."""
    size = 1
    for d in shape:
        size *= d
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if SAMPLES is None:
            return
        rec = SAMPLES.setdefault(name, {"shapes": {}, "largest": (-1, None, None)})
        rec["shapes"][shape] = rec["shapes"].get(shape, 0) + 1
        if size > rec["largest"][0]:
            rec["largest"] = (size, shape, args)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; anything else raises."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed or unsupported devices: {sorted(map(str, devices))}")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (once per source content) and load every kernel library."""
    with _BUILD_LOCK:
        if not _LIBS:
            _build_and_load()
    return _LIBS


def _build_and_load() -> None:
    global BUILD_SECONDS
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    failures = []
    for src, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[src.stem] = log
        if p.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    for src in sources:
        lib = ctypes.CDLL(str(_lib_path(src)))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        _LIBS[src.stem] = lib
    BUILD_SECONDS = time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    return build_all()[stem]


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current stream of `device` (not of the thread's current device)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@contextmanager
def on_device(device: torch.device):
    """Make `device` the thread's current CUDA device, and yield its current
    stream: a kernel launched through ctypes runs on the current device."""
    with torch.cuda.device(device):
        yield stream_ptr(device)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require(t: torch.Tensor, dtypes, name: str) -> None:
    """Raise unless `t` is a contiguous 1-D tensor of one of `dtypes`."""
    if t.dim() != 1 or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(
            f"{name}: want a contiguous 1-D tensor of {dtypes}, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )
