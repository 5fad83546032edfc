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
lock.

The kernels are built at first use: every source in `csrc/` is compiled by
`nvcc` into its own shared library with a plain C interface, all sources at
once in parallel, into `materialize_tpu_torch/_build/`, and loaded with
ctypes. A missing `nvcc` or a failed build raises.

Every wrapper launches through `run`, the one launch path: it passes the
tensors' device index and that device's current stream (a raw handle, no
`torch.cuda.Stream` object) to the C entry point, which makes the device
current around the launch and returns the launch's error code. Pointers go
as plain ints. The libraries are loaded as `ctypes.PyDLL`, so a launch keeps
the interpreter lock: it takes microseconds, and a mesh worker that released
the lock for it could queue behind the other workers to get it back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
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
# C entry points of csrc/*.cu: (argtypes, restype). Every launching entry
# point takes the device index first and the stream last. Pointers and the
# stream are c_void_p, or ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "mz_probe": ((_INT, _VP, _I64, _VP, _I64, _INT, _VP, _VP), _INT),
    "mz_probe2": ((_INT, _VP, _VP, _I64, _VP, _VP, _I64, _INT, _VP, _VP), _INT),
    "mz_multi_take": ((_INT, _VP, _VP, _INT, _INT, _VP, _I64, _I64, _VP), _INT),
    "mz_probe_shape": ((_INT, _INT), _INT),
    "mz_run_sum_shape": ((_INT,), _INT),
    "mz_run_sum_scratch_bytes": ((_I64, _INT), _I64),
    "mz_run_sum": ((_INT, _VP, _VP, _INT, _I64, _VP, _VP), _INT),
    "mz_route_dest": ((_INT, _VP, _I64, _INT, _VP, _VP), _INT),
    "mz_bucket_rank_shape": ((_INT,), _INT),
    "mz_bucket_rank": ((_INT, _VP, _I64, _VP, _VP, _I64, _VP), _INT),
}

_FNS: dict = {}  # C entry point name -> its bound function, filled once by the build
BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc's output (registers, spills)
BUILD_SECONDS: float | None = None
_raw_stream = None  # torch's current raw stream of a device index, bound at the build


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
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if SAMPLES is None:
            return
        size = 1
        for d in shape:
            size *= d
        rec = SAMPLES.setdefault(name, {"shapes": {}, "largest": (-1, None, None)})
        rec["shapes"][shape] = rec["shapes"].get(shape, 0) + 1
        if size > rec["largest"][0]:
            rec["largest"] = (size, shape, args)


def device_index(*tensors: torch.Tensor) -> int:
    """The CUDA device index when every tensor lies on one CUDA device, -1
    when every one lies on the CPU; anything else raises."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != dev:
                break
        else:
            return dev
    elif all(t.is_cpu for t in tensors):
        return -1
    devices = sorted({str(t.device) for t in tensors})
    raise ValueError(f"kernel inputs on mixed or unsupported devices: {devices}")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> None:
    """Build (once per source content) and load every kernel library."""
    with _BUILD_LOCK:
        if not _FNS:
            _build_and_load()


def _build_and_load() -> None:
    global BUILD_SECONDS, _raw_stream
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
    _raw_stream = torch._C._cuda_getCurrentRawStream
    fns = {}
    for src in sources:
        lib = ctypes.PyDLL(str(_lib_path(src)))
        for name, (argtypes, restype) in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
                fns[name] = fn
    _FNS.update(fns)  # last: a reader that finds an entry finds it bound
    BUILD_SECONDS = time.perf_counter() - t0


def c_fn(name: str):
    """The bound C function `name` of the kernel libraries (built at first
    use; later calls take no lock)."""
    fn = _FNS.get(name)
    if fn is None:
        build_all()
        fn = _FNS[name]
    return fn


def run(entry: str, dev: int, *args) -> None:
    """Launch C entry point `entry` on CUDA device `dev`, on that device's
    current stream; raise if the launch failed. `args` are the entry point's
    arguments between the device index and the stream; tensors go as their
    `data_ptr()`."""
    err = c_fn(entry)(dev, *args, _raw_stream(dev))
    if err:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")


def require(t: torch.Tensor, dtypes, name: str) -> None:
    """Raise unless `t` is a contiguous 1-D tensor of one of `dtypes`."""
    if t.dim() != 1 or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(
            f"{name}: want a contiguous 1-D tensor of {dtypes}, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )
