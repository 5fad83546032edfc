"""Switchable torch.profiler hooks for the fused path.

Counterpart of materialize_tpu/obs/profiler.py. `configure(enabled,
dump_dir)` turns the hooks on or off; with a dump directory it also starts
a `torch.profiler` session, and turning the hooks off stops it and writes
its Chrome trace there. While the hooks are on, `FusedDataflow` wraps each
tick in `annotate("mzt_fused_tick:<name>")` and each plan node's emission
in `named_scope("mzt:<Node>")`, both `torch.profiler.record_function`
ranges, so a profiler trace of a tick names the tick and its plan nodes.

Off, every hook costs one check of a module-level bool and touches nothing
of the profiler.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_enabled = False
_session = None  # the torch.profiler.profile started by `configure`
_dir = ""
_log = logging.getLogger("materialize_tpu_torch.profiler")


def configure(enabled: bool, dump_dir: str = "") -> None:
    """Turn the hooks on or off; with `dump_dir`, start (on) or stop and
    export (off) a torch.profiler session. Failures log and leave the
    session off rather than raise: profiling never takes the engine down."""
    global _enabled, _session, _dir
    with _lock:
        _dir = dump_dir or ""
        if enabled and not _enabled:
            _enabled = True
            if _dir:
                try:
                    import torch
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        acts.append(ProfilerActivity.CUDA)
                    _session = profile(activities=acts)
                    _session.start()
                except Exception as e:  # pragma: no cover - platform-specific
                    _session = None
                    _log.warning("profiler start failed: %s", e)
        elif not enabled and _enabled:
            _enabled = False
            session, _session = _session, None
            if session is not None:
                try:
                    session.stop()
                    os.makedirs(_dir, exist_ok=True)
                    session.export_chrome_trace(os.path.join(_dir, "trace.json"))
                except Exception as e:  # pragma: no cover - platform-specific
                    _log.warning("profiler stop failed: %s", e)


def enabled() -> bool:
    return _enabled


@contextmanager
def annotate(name: str):
    """A named range around a host-side region (one fused tick)."""
    if not _enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


@contextmanager
def named_scope(name: str):
    """A named range around one plan node's emission."""
    if not _enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
