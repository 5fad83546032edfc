#!/usr/bin/env python3
"""Sweep the tile shapes of the port's `probe`, `probe2` and `run_sum` kernels
on one NVIDIA GPU, at the main path's own inputs.

    python3 scripts/port_kernel_sweep.py [--out FILE] [--parent DIR]

1. Runs the single-GPU Q3 tick at TPC-H SF1 as chip_smoke.py does (hydration,
   a warm-up tick, five timed churn ticks), then the 4-worker sharded tick,
   and keeps the arguments of every `probe` and `probe2` call of both
   paths' timed ticks. It prints how their tiles split between the tile
   kernel's branches (chip_smoke.probe_branch_mix, and the same for pairs)
   for each candidate shape.
2. Builds csrc/probe.cu and csrc/run_sum.cu once per candidate shape: a
   copy of the source with some of its shape constants rewritten (all
   builds at once; with --parent also that checkout's sources). Each
   build's kernel is checked against the plain version and timed by CUDA
   events, in turns with the shipped build (shipped, candidate, candidate,
   shipped; medians): `probe` and `probe2` at their largest call of the
   single path, with every query PAD_HASH, and over all of their calls on
   each path; `run_sum` at its largest call, and on the same columns with a
   run at every row and with one run over all rows.

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

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from materialize_tpu_torch.ops.kernels import probe, registry, segsum  # noqa: E402

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


def parent_run_sum_call(lib, args):
    """run_sum of a build whose entry point takes one column a call."""
    rs, cols = args
    n = rs.numel()
    outs = tuple(torch.empty_like(c) for c in cols)
    width = max(c.element_size() for c in cols)
    scratch = rs.new_empty(lib.mz_run_sum_scratch_bytes(n, width), dtype=torch.uint8)
    dev, stream = rs.get_device(), torch.cuda.current_stream().cuda_stream
    lib.mz_run_sum.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)

    def fn():
        for c, o in zip(cols, outs):
            err = lib.mz_run_sum(dev, rs.data_ptr(), c.data_ptr(), n, c.element_size(),
                                 o.data_ptr(), scratch.data_ptr(), stream)
            if err:
                raise RuntimeError(f"mz_run_sum: cudaError {err}")
        return outs
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(registry.BUILD_DIR / "sweep" / "sweep.jsonl"))
    ap.add_argument("--parent", help="a checkout whose csrc/probe.cu and csrc/run_sum.cu are "
                    "timed beside every build (its run_sum entry point taking one column a "
                    "call)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = [{"device": smi, "torch": torch.__version__}]

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    probe_src = (registry.CSRC / "probe.cu").read_text()
    run_sum_src = (registry.CSRC / "run_sum.cu").read_text()
    variants = {name: rewrite(probe_src, c) for name, c in PROBE_BUILDS.items()}
    variants.update({name: rewrite(run_sum_src, c) for name, c in RUN_SUM_BUILDS.items()})
    if opts.parent:
        parent = Path(opts.parent) / "materialize_tpu_torch" / "csrc"
        variants["probe-parent"] = parent / "probe.cu"
        variants["run_sum-parent"] = parent / "run_sum.cu"
    registry.build_all()
    libs = build(variants)
    chip_smoke.phase(f"{len(libs)} sweep builds done")

    # 1. every probe and probe2 call of both paths' timed ticks
    calls = {("probe", "single"): [], ("probe", "sharded"): [], ("probe2", "single"): [],
             ("probe2", "sharded"): []}
    path = ["single"]
    counted = registry.launch

    def launch(name, args, shape):
        counted(name, args, shape)
        if registry.SAMPLES is not None and name in ("probe", "probe2"):
            calls[name, path[0]].append(tuple(x.clone() if torch.is_tensor(x) else x
                                              for x in args))

    registry.launch = launch
    try:
        q3 = chip_smoke.run_q3("cuda", sf=1.0, ticks=5, frac=0.02, n_cust_retract=1000)
        path[0] = "sharded"
        chip_smoke.run_sharded(sf=1.0, ticks=5, frac=0.02, n_cust_retract=1000)
    finally:
        registry.launch = counted
    torch.cuda.synchronize()
    samples = q3["samples"]

    # their branch mix at each build's shape
    families = {"probe": "probe-", "probe2": "probe2-"}
    names = {kernel: ["probe-shipped", *(n for n in list(PROBE_BUILDS)[1:] if n.startswith(fam))]
             for kernel, fam in families.items()}
    for (kernel, where), cs in calls.items():
        sizes: dict = {}
        for c in cs:
            key = "x".join(str(c[i].numel()) for i in ((0, 1) if kernel == "probe" else (0, 2)))
            sizes[key] = sizes.get(key, 0) + 1
        emit({"calls": kernel, "path": where, "shapes": sizes})
        for name in names[kernel]:
            if name == "probe2-branching-compare":
                continue
            items, rows = shape_of(variants[name], "Key1" if kernel == "probe" else "Key2")
            total: dict = {}
            for c in cs:
                add_mix(total, chip_smoke.probe_branch_mix(c[0], c[1], items, rows)
                        if kernel == "probe" else pair_branch_mix(c, items, rows))
            emit({"branch_mix": kernel, "path": where, "build": name, **total})

    # 2. each build in turns with the shipped one
    pad = 0xFFFFFFFF
    a, q, side = samples["probe"]["largest"][2]
    ah, al, qh, ql, side2 = samples["probe2"]["largest"][2]
    layouts = {
        "probe": {"largest call": [(a, q, side)],
                  "largest call, all PAD_HASH": [(a, torch.full_like(q, pad), side)],
                  "all single-path calls": calls["probe", "single"],
                  "all sharded-path calls": calls["probe", "sharded"]},
        "probe2": {"largest call": [(ah, al, qh, ql, side2)],
                   "largest call, all PAD_HASH": [(ah, al, torch.full_like(qh, pad),
                                                   torch.zeros_like(ql), side2)],
                   "all single-path calls": calls["probe2", "single"],
                   "all sharded-path calls": calls["probe2", "sharded"]},
    }
    rs, cols = samples["run_sum"]["largest"][2]
    every = torch.ones_like(rs)
    one = torch.zeros_like(rs)
    one[0] = True
    runs = {"largest call": (rs, cols), "every row a run": (every, cols),
            "one run": (one, cols)}
    parent_build = ["probe-parent"] if opts.parent else []
    cases = [("probe", probe_calls, args, names["probe"] + parent_build, layout)
             for layout, args in layouts["probe"].items()]
    cases += [("probe2", probe2_calls, args, names["probe2"] + parent_build, layout)
              for layout, args in layouts["probe2"].items()]
    cases += [("run_sum", run_sum_call, args,
               [*RUN_SUM_BUILDS] + (["run_sum-parent"] if opts.parent else []), layout)
              for layout, args in runs.items()]
    for layout, cs in layouts["probe"].items():
        emit({"kernel": "probe", "build": "torch.searchsorted", "layout": layout,
              "ms": chip_smoke.time_ms(lambda: [torch.searchsorted(a_, q_, right=s_ == "right")
                                                for a_, q_, s_ in cs], iters=5, warmup=1)})
    plains = {"probe": lambda x: tuple(probe.plain_searchsorted(*c) for c in x),
              "probe2": lambda x: tuple(probe.plain_searchsorted2(*c) for c in x),
              "run_sum": lambda x: segsum.plain_run_sum(*x)}
    for kernel, call, args, builds, layout in cases:
        want = plains[kernel](args)
        shipped = call(libs[builds[0]], args)
        iters = 5 if layout.startswith("all") else 20
        for name in builds:
            fn = (parent_run_sum_call if name == "run_sum-parent" else call)(libs[name], args)
            if not chip_smoke._equal(fn(), want):
                raise AssertionError(f"{name} differs from the plain {kernel}")
            torch.cuda.synchronize()
            base_ms, ms = chip_smoke.in_turns(
                lambda f: chip_smoke.time_ms(f, iters=iters, warmup=1), shipped, fn)
            emit({"kernel": kernel, "build": name, "layout": layout, "ms": ms,
                  "shipped_ms": base_ms})
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
