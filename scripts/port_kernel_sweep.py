#!/usr/bin/env python3
"""Sweep the tile shapes of the port's `probe`, `probe2`, `run_sum` and
`bucket_rank` kernels on one NVIDIA GPU, at the main path's own inputs.

    python3 scripts/port_kernel_sweep.py [--out FILE] [--parent DIR]
                                         [--kernels probe,probe2,run_sum,bucket_rank]
                                         [--builds NAME,...] [--rounds R]

1. Runs the single-GPU Q3 tick at TPC-H SF1 as chip_smoke.py does (hydration,
   a warm-up tick, five timed churn ticks), then the 4-worker sharded tick,
   and keeps the arguments of every `probe` and `probe2` call of both
   paths' timed ticks, and of every `bucket_rank` call of the sharded ones.
   It prints how the searches' tiles split between the tile kernel's
   branches (chip_smoke.probe_branch_mix, and the same for pairs) for each
   candidate shape. With only `bucket_rank` asked for, the single path is
   not run.
2. Builds csrc/probe.cu, csrc/run_sum.cu and csrc/route.cu once per
   candidate shape: a copy of the source with some of its shape constants
   rewritten (all builds at once; with --parent also that checkout's
   sources). Each build's kernel is checked against the plain version and
   timed by CUDA events, in turns with the shipped build (shipped,
   candidate, candidate, shipped; medians): `probe` and `probe2` at their
   largest call of the single path, with every query PAD_HASH, and over all
   of their calls on each path; `run_sum` at its largest call, and on the
   same columns with a run at every row and with one run over all rows;
   `bucket_rank` at its largest call, over all of its calls, and at the
   largest call's size with one run (the longest look-back), a run start at
   every row (none) and unsorted keys, and with one run of 2^22 rows.
   `bucket_rank`'s calls are short, so its builds are also timed by the
   profiler after every CUDA-event timing, in turns with the shipped build
   for R rounds (`device_ms` and `shipped_device_ms`, medians, memsets
   included; `device_events` and `device_ms_by_name` a set of calls).
   --builds keeps only the named builds beside the shipped one (and the
   parent's).

Prints one JSON line per result, and writes them to --out. Needs a CUDA
device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from materialize_tpu_torch.ops.kernels import probe, registry, route, segsum  # noqa: E402

# build name -> changes to csrc/probe.cu, each a constant rewritten (the text
# after which it is first defined, its name, its new value) or a text
# replaced (the old text, the new); the first build is the source as it
# stands. "probe-" builds change probe's kernel, "probe2-" builds probe2's.
PROBE_BUILDS = {
    "probe-shipped": (),
    "probe-items1": (("struct Shape<Key1>", "kItems", "1"),),
    "probe-items4": (("struct Shape<Key1>", "kItems", "4"),),
    "probe-4kb": (("struct Shape<Key1>", "kWindowBytes", "4 * 1024"),),
    "probe-16kb": (("struct Shape<Key1>", "kWindowBytes", "16 * 1024"),),
    "probe-32kb": (("struct Shape<Key1>", "kWindowBytes", "32 * 1024"),),
    "probe-ways2": (("", "kWays", "2"),),
    "probe-ways8": (("", "kWays", "8"),),
    "probe2-items2": (("struct Shape<Key2>", "kItems", "2"),),
    "probe2-items8": (("struct Shape<Key2>", "kItems", "8"),),
    "probe2-4kb": (("struct Shape<Key2>", "kWindowBytes", "4 * 1024"),),
    "probe2-8kb": (("struct Shape<Key2>", "kWindowBytes", "8 * 1024"),),
    "probe2-16kb": (("struct Shape<Key2>", "kWindowBytes", "16 * 1024"),),
    "probe2-branching-compare": (("return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo));",
                                  "return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);"),),
}
# the same for csrc/run_sum.cu: rows a thread, threads a block, blocks an SM
# must fit
RUN_SUM_BUILDS = {
    "run_sum-shipped": (),
    "run_sum-items8-min1": (("", "kItems", "8"), ("", "kMinBlocks", "1")),
    "run_sum-items8-min4": (("", "kItems", "8"), ("", "kMinBlocks", "4")),
    "run_sum-min3": (("", "kMinBlocks", "3"),),
    "run_sum-512t-min1": (("", "kThreads", "512"), ("", "kMinBlocks", "1")),
}
# the same for csrc/route.cu's bucket_rank: rows a thread, threads a block,
# blocks an SM must fit, tiles a lane checks at each look-back step, words
# between two status words, 16-byte or 4-byte loads and stores; and, to
# measure what the ticket costs,
# the tile taken from blockIdx.x (not shippable: only the tickets guarantee
# that a tile's left neighbours run)
BUCKET_RANK_BUILDS = {
    "bucket_rank-shipped": (),
    "bucket_rank-items8": (("", "kItems", "8"),),
    "bucket_rank-items32": (("", "kItems", "32"), ("", "kMinBlocks", "2")),
    "bucket_rank-256t": (("", "kThreads", "256"),),
    "bucket_rank-512t-min2": (("", "kThreads", "512"), ("", "kMinBlocks", "2")),
    "bucket_rank-min1": (("", "kMinBlocks", "1"),),
    "bucket_rank-look1": (("", "kLook", "1"),),
    "bucket_rank-look4": (("", "kLook", "4"),),
    "bucket_rank-look16": (("", "kLook", "16"),),
    "bucket_rank-stride1": (("", "kStride", "1"),),
    "bucket_rank-stride8": (("", "kStride", "8"),),
    "bucket_rank-scalar-io": (("const bool vec = t0", "const bool vec = false && t0"),),
    "bucket_rank-blockidx": (("(int64_t)atomicAdd(words, 1u)", "(int64_t)blockIdx.x"),),
}


def rewrite(src: str, changes) -> str:
    """`src` with each change applied: (old, new) replaces the one
    occurrence of `old`; (after, name, value) the first definition
    `constexpr int name = ...;` after the first occurrence of `after`."""
    for change in changes:
        if len(change) == 2:
            old, new = change
            if src.count(old) != 1:
                raise ValueError(f"not found once: {old!r}")
            src = src.replace(old, new)
            continue
        after, name, value = change
        at = src.index(after)
        pat = re.compile(rf"(constexpr int {name} = )[^;]+;")
        found = pat.search(src, at)
        if found is None:
            raise ValueError(f"no constant {name} after {after!r}")
        src = src[:found.start()] + f"{found.group(1)}{value};" + src[found.end():]
    return src


def shape_of(src: str, key: str) -> tuple:
    """(queries a thread, rows staged) of probe.cu's Shape<key> in `src`."""
    at = src.index(f"struct Shape<{key}>")
    items = int(re.compile(r"kItems = (\d+);").search(src, at).group(1))
    kb = int(re.compile(r"kWindowBytes = (\d+) \* 1024;").search(src, at).group(1))
    return items, kb * 1024 // (8 if key == "Key1" else 16)


def build(variants: dict) -> dict:
    """nvcc every variant (name -> source text or path) at once; load each."""
    out_dir = registry.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        if isinstance(src, str):
            path = out_dir / f"{name}.cu"
            path.write_text(src)
        else:
            path = src
        so = out_dir / f"{name}.so"
        cmd = [registry._nvcc(), *registry.NVCC_FLAGS, "-I", str(registry.CSRC), "-o", str(so),
               str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.PyDLL(str(so))
        for fn_name, (argtypes, restype) in registry._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, restype
        libs[name] = lib
    return libs


def probe_calls(lib, calls):
    """One function that runs mz_probe over every call of `calls`."""
    outs = [torch.empty_like(c[1]) for c in calls]
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        for (a, q, side), out in zip(calls, outs):
            err = lib.mz_probe(a.get_device(), a.data_ptr(), a.numel(), q.data_ptr(), q.numel(),
                               int(side == "right"), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"mz_probe: cudaError {err}")
        return tuple(outs)
    return fn


def probe2_calls(lib, calls):
    """One function that runs mz_probe2 over every call of `calls`."""
    outs = [torch.empty_like(c[2]) for c in calls]
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        for (ah, al, qh, ql, side), out in zip(calls, outs):
            err = lib.mz_probe2(ah.get_device(), ah.data_ptr(), al.data_ptr(), ah.numel(),
                                qh.data_ptr(), ql.data_ptr(), qh.numel(), int(side == "right"),
                                out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"mz_probe2: cudaError {err}")
        return tuple(outs)
    return fn


def run_sum_call(lib, args):
    rs, cols = args
    k, n = len(cols), rs.numel()
    outs = tuple(torch.empty_like(c) for c in cols)
    scratch = rs.new_empty(lib.mz_run_sum_scratch_bytes(n, k), dtype=torch.uint8)
    ptrs = (ctypes.c_int64 * (3 * k))(*[c.data_ptr() for c in cols],
                                      *[o.data_ptr() for o in outs],
                                      *[c.element_size() for c in cols])
    dev, stream = rs.get_device(), torch.cuda.current_stream().cuda_stream

    def fn():
        err = lib.mz_run_sum(dev, rs.data_ptr(), ptrs, k, n, scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"mz_run_sum: cudaError {err}")
        return outs
    return fn


def bucket_rank_calls(lib, calls):
    """One function that runs mz_bucket_rank over every key vector of
    `calls`: one memset and one launch a call, or (the parent's build, which
    has `mz_bucket_rank_scratch_bytes`) three launches."""
    parent = hasattr(lib, "mz_bucket_rank_scratch_bytes")
    if parent:  # its entry point takes no scratch size
        size = lib.mz_bucket_rank_scratch_bytes
        size.argtypes, size.restype = (ctypes.c_int64,), ctypes.c_int64
        lib.mz_bucket_rank.argtypes = lib.mz_bucket_rank.argtypes[:5] + (ctypes.c_void_p,)
        words = [-(-size(k.numel()) // 4) for k in calls]
    else:
        shape = (lib.mz_bucket_rank_shape(0), lib.mz_bucket_rank_shape(1))
        words = [route.bucket_rank_scratch_words(k.numel(), shape) for k in calls]
    outs = [torch.empty_like(k) for k in calls]
    scratch = [k.new_empty(max(w, 1)) for k, w in zip(calls, words)]
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        for k, out, sc, w in zip(calls, outs, scratch, words):
            args = (k.get_device(), k.data_ptr(), k.numel(), out.data_ptr(), sc.data_ptr())
            err = lib.mz_bucket_rank(*args, *(() if parent else (w,)), stream)
            if err:
                raise RuntimeError(f"mz_bucket_rank: cudaError {err}")
        return tuple(outs)
    return fn


def add_mix(total: dict, mix: dict) -> None:
    for key, val in mix.items():
        if key in ("tile", "window_rows"):
            total[key] = val
        elif key in ("widest_window", "largest_stride"):
            total[key] = max(total.get(key, 0), val)
        else:
            total[key] = total.get(key, 0) + val
    total["calls"] = total.get("calls", 0) + 1


def pair_branch_mix(call, items: int, window: int) -> dict:
    """chip_smoke.probe_branch_mix for a `probe2` call."""
    def less(ah, al, bh, bl):
        return (ah < bh) | ((ah == bh) & (al < bl))

    ah, al, qh, ql, _side = call
    m, tile = qh.numel(), 256 * items
    starts = torch.arange(0, m, tile, device=qh.device)
    ends = (starts + tile).clamp(max=m)
    fh, fl, lh, ll = qh[starts], ql[starts], qh[ends - 1], ql[ends - 1]
    down = torch.nonzero(less(qh[1:], ql[1:], qh[:-1], ql[:-1])).flatten() + 1
    unsorted = torch.zeros(starts.numel(), dtype=torch.bool, device=qh.device)
    unsorted[down[down % tile != 0] // tile] = True
    width = (probe.plain_searchsorted2(ah, al, lh, ll, "left")
             - probe.plain_searchsorted2(ah, al, fh, fl, "right"))
    equal = ~unsorted & (fh == lh) & (fl == ll)
    live = ~unsorted & ~equal
    branches = {"staged": live & (width <= window), "sampled": live & (width > window)}
    owner = torch.arange(m, device=qh.device) // tile
    inner = ~(((qh == fh[owner]) & (ql == fl[owner])) | ((qh == lh[owner]) & (ql == ll[owner])))
    mix = {"tiles": int(starts.numel()), "all_equal": int(equal.sum()),
           "unsorted": int(unsorted.sum())}
    for name, sel in branches.items():
        mix[name] = int(sel.sum())
        mix[f"between_{name}"] = int((inner & sel[owner]).sum())
    mix["widest_window"] = int(width[live].max()) if bool(live.any()) else 0
    return mix


KERNELS = ("probe", "probe2", "run_sum", "bucket_rank")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(registry.BUILD_DIR / "sweep" / "sweep.jsonl"))
    ap.add_argument("--parent", help="a checkout whose csrc/probe.cu, csrc/run_sum.cu and "
                    "csrc/route.cu are timed beside every build")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to sweep, comma-separated (default: all)")
    ap.add_argument("--builds", help="only these builds beside the shipped ones, comma-separated")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of profiler readings in turns (bucket_rank)")
    opts = ap.parse_args()
    kernels = opts.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes some of {KERNELS}")
    keep = None if opts.builds is None else set(opts.builds.split(","))
    if not torch.cuda.is_available():
        print("port_kernel_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = [{"device": smi, "torch": torch.__version__}]

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    sources = {"probe": "probe.cu", "probe2": "probe.cu", "run_sum": "run_sum.cu",
               "bucket_rank": "route.cu"}
    families = {"probe": PROBE_BUILDS, "probe2": PROBE_BUILDS, "run_sum": RUN_SUM_BUILDS,
                "bucket_rank": BUCKET_RANK_BUILDS}
    variants: dict = {}
    for kernel in kernels:
        src = (registry.CSRC / sources[kernel]).read_text()
        variants.update({name: rewrite(src, c) for name, c in families[kernel].items()
                         if keep is None or name in keep or name.endswith("-shipped")})
        if opts.parent:
            stem = "probe" if kernel == "probe2" else kernel
            variants[f"{stem}-parent"] = (Path(opts.parent) / "materialize_tpu_torch" / "csrc"
                                          / sources[kernel])
    registry.build_all()
    libs = build(variants)
    chip_smoke.phase(f"{len(libs)} sweep builds done")

    # 1. every probe and probe2 call of both paths' timed ticks, every
    # bucket_rank call of the sharded ones
    calls = {(k, where): [] for k in ("probe", "probe2", "bucket_rank")
             for where in ("single", "sharded")}
    path = ["single"]
    counted = registry.launch

    def launch(name, args, shape):
        counted(name, args, shape)
        if registry.SAMPLES is not None and name in kernels and (name, path[0]) in calls:
            calls[name, path[0]].append(tuple(x.clone() if torch.is_tensor(x) else x
                                              for x in args))

    registry.launch = launch
    try:
        if {"probe", "probe2", "run_sum"} & set(kernels):
            samples = chip_smoke.run_q3("cuda", sf=1.0, ticks=5, frac=0.02,
                                        n_cust_retract=1000)["samples"]
        path[0] = "sharded"
        sh_samples = chip_smoke.run_sharded(sf=1.0, ticks=5, frac=0.02,
                                            n_cust_retract=1000)["samples"]
    finally:
        registry.launch = counted
    torch.cuda.synchronize()

    # their branch mix at each build's shape
    names = {kernel: [f"{kernel}-shipped"] if kernel in ("run_sum", "bucket_rank") else
             ["probe-shipped", *(n for n in list(PROBE_BUILDS)[1:] if n.startswith(kernel + "-"))]
             for kernel in kernels}
    for (kernel, where), cs in calls.items():
        if kernel not in kernels or kernel == "bucket_rank":
            continue
        sizes: dict = {}
        for c in cs:
            key = "x".join(str(c[i].numel()) for i in ((0, 1) if kernel == "probe" else (0, 2)))
            sizes[key] = sizes.get(key, 0) + 1
        emit({"calls": kernel, "path": where, "shapes": sizes})
        for name in names[kernel]:
            if name == "probe2-branching-compare" or name not in variants:
                continue
            items, rows = shape_of(variants[name], "Key1" if kernel == "probe" else "Key2")
            total: dict = {}
            for c in cs:
                add_mix(total, chip_smoke.probe_branch_mix(c[0], c[1], items, rows)
                        if kernel == "probe" else pair_branch_mix(c, items, rows))
            emit({"branch_mix": kernel, "path": where, "build": name, **total})

    # 2. each build in turns with the shipped one
    pad = 0xFFFFFFFF
    layouts: dict = {}
    if "probe" in kernels:
        a, q, side = samples["probe"]["largest"][2]
        layouts["probe"] = {"largest call": [(a, q, side)],
                            "largest call, all PAD_HASH": [(a, torch.full_like(q, pad), side)],
                            "all single-path calls": calls["probe", "single"],
                            "all sharded-path calls": calls["probe", "sharded"]}
    if "probe2" in kernels:
        ah, al, qh, ql, side2 = samples["probe2"]["largest"][2]
        layouts["probe2"] = {"largest call": [(ah, al, qh, ql, side2)],
                             "largest call, all PAD_HASH": [(ah, al, torch.full_like(qh, pad),
                                                             torch.zeros_like(ql), side2)],
                             "all single-path calls": calls["probe2", "single"],
                             "all sharded-path calls": calls["probe2", "sharded"]}
    if "run_sum" in kernels:
        rs, cols = samples["run_sum"]["largest"][2]
        one = torch.zeros_like(rs)
        one[0] = True
        layouts["run_sum"] = {"largest call": (rs, cols),
                              "every row a run": (torch.ones_like(rs), cols),
                              "one run": (one, cols)}
    if "bucket_rank" in kernels:
        (k,) = sh_samples["bucket_rank"]["largest"][2]
        n = k.numel()
        layouts["bucket_rank"] = {
            "largest call": [k],
            "all sharded-path calls": [c[0] for c in calls["bucket_rank", "sharded"]],
            "one run": [torch.zeros_like(k)],
            "a run start at every row": [torch.arange(n, dtype=torch.int32, device=k.device)],
            "unsorted": [torch.randint(0, 5, (n,), dtype=torch.int32, device=k.device,
                                       generator=torch.Generator(device=k.device).manual_seed(0))],
            "one run, n = 2^22": [torch.zeros(1 << 22, dtype=torch.int32, device=k.device)],
        }
        emit({"calls": "bucket_rank", "path": "sharded",
              "shapes": {str(s[0]): c for s, c in sh_samples["bucket_rank"]["shapes"].items()}})
    runners = {"probe": probe_calls, "probe2": probe2_calls, "run_sum": run_sum_call,
               "bucket_rank": bucket_rank_calls}
    plains = {"probe": lambda x: tuple(probe.plain_searchsorted(*c) for c in x),
              "probe2": lambda x: tuple(probe.plain_searchsorted2(*c) for c in x),
              "run_sum": lambda x: segsum.plain_run_sum(*x),
              "bucket_rank": lambda x: tuple(route.plain_bucket_rank(c) for c in x)}
    if "probe" in kernels:
        for layout, cs in layouts["probe"].items():
            emit({"kernel": "probe", "build": "torch.searchsorted", "layout": layout,
                  "ms": chip_smoke.time_ms(lambda: [torch.searchsorted(a_, q_, right=s_ == "right")
                                                    for a_, q_, s_ in cs], iters=5, warmup=1)})
    profiled = []
    for kernel in kernels:
        stem = "probe" if kernel == "probe2" else kernel
        builds = names[kernel] + ([f"{stem}-parent"] if opts.parent else [])
        if kernel in ("run_sum", "bucket_rank"):
            builds = [*families[kernel]] + builds[1:]
        builds = [b for b in builds if b in libs]
        for layout, args in layouts[kernel].items():
            want = plains[kernel](args)
            shipped = runners[kernel](libs[builds[0]], args)
            iters = 5 if layout.startswith("all") else 20
            for name in builds:
                fn = runners[kernel](libs[name], args)
                if not chip_smoke._equal(fn(), want):
                    raise AssertionError(f"{name} differs from the plain {kernel}")
                torch.cuda.synchronize()
                base_ms, ms = chip_smoke.in_turns(
                    lambda f: chip_smoke.time_ms(f, iters=iters, warmup=1), shipped, fn)
                row = {"kernel": kernel, "build": name, "layout": layout, "ms": ms,
                       "shipped_ms": base_ms}
                if kernel == "bucket_rank":
                    row["calls"] = len(args)
                    profiled.append((row, shipped, fn, iters))
                else:
                    emit(row)
    # the profiler after every CUDA-event timing (a session slows later launches)
    for row, shipped, fn, iters in profiled:
        readings = {"shipped": [], "build": []}
        for _ in range(opts.rounds):
            for which, f in (("shipped", shipped), ("build", fn), ("build", fn),
                             ("shipped", shipped)):
                readings[which].append(chip_smoke.kernel_ms(f, iters=iters))
        # a reading of Nones: the profiler lost events
        got = [r for r in readings["build"] if r[0] is not None]
        base = [r[0] for r in readings["shipped"] if r[0] is not None]
        row["device_ms"] = float(np.median([r[0] for r in got])) if got else "not measured"
        row["shipped_device_ms"] = float(np.median(base)) if base else "not measured"
        row["device_events"] = got[0][1] if got else None
        row["device_ms_by_name"] = {name: float(np.median([r[2][name] for r in got]))
                                    for name in got[0][2]} if got else None
        emit(row)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
