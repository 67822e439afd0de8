"""Native (C++) runtime bindings: thread pool, state store, policy
buffer and the agent's plan loop.

Counterpart of humanoid_mujoco_tpu/native/__init__.py. `runtime.cpp`
(a copy of the JAX package's, with no framework dependency) rebuilds the
reference's runtime substrate (mjpc/threadpool.cc, states/state.cc, the
Agent plan thread) as a small shared library loaded with ctypes.

At first use it is compiled with `g++ -O2 -shared -fPIC -std=c++17
-pthread` into `build/native/` at the root of the checkout (listed in
.gitignore), named by a hash of the source and flags, as the CUDA
kernels are (kernels.py). A failed build raises with g++'s output:
there is no pure-Python stand-in. Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the built library lives: build/native/, named by a hash of
    the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libhmt_runtime-{h.hexdigest()[:16]}.so"


def _build(so: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)


def load():
    """Load (building if needed) the native runtime library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        # signatures
        lib.threadpool_create.restype = ctypes.c_void_p
        lib.threadpool_create.argtypes = [ctypes.c_int]
        lib.threadpool_destroy.argtypes = [ctypes.c_void_p]
        lib.threadpool_schedule.argtypes = [ctypes.c_void_p,
                                            ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.threadpool_wait_count.argtypes = [ctypes.c_void_p,
                                              ctypes.c_long]
        lib.threadpool_reset_count.argtypes = [ctypes.c_void_p]
        lib.threadpool_count.restype = ctypes.c_long
        lib.threadpool_count.argtypes = [ctypes.c_void_p]
        lib.state_create.restype = ctypes.c_void_p
        lib.state_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.state_destroy.argtypes = [ctypes.c_void_p]
        lib.state_set.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_double]
        lib.state_get.restype = ctypes.c_double
        lib.state_get.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double)]
        lib.state_version.restype = ctypes.c_long
        lib.state_version.argtypes = [ctypes.c_void_p]
        lib.policy_create.restype = ctypes.c_void_p
        lib.policy_destroy.argtypes = [ctypes.c_void_p]
        lib.policy_publish.argtypes = [ctypes.c_void_p,
                                       ctypes.c_char_p, ctypes.c_long]
        lib.policy_size.restype = ctypes.c_long
        lib.policy_size.argtypes = [ctypes.c_void_p]
        lib.policy_read.restype = ctypes.c_long
        lib.policy_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long]
        lib.policy_version.restype = ctypes.c_long
        lib.policy_version.argtypes = [ctypes.c_void_p]
        lib.agentloop_create.restype = ctypes.c_void_p
        lib.agentloop_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.agentloop_stop.argtypes = [ctypes.c_void_p]
        lib.agentloop_iterations.restype = ctypes.c_long
        lib.agentloop_iterations.argtypes = [ctypes.c_void_p]
        lib.agentloop_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


PLAN_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class _Handle:
    """A native object: `_p` its pointer, freed by `_free` on close()."""

    _p = None
    _free = ""

    def close(self):
        if self._p:
            getattr(self._lib, self._free)(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeThreadPool(_Handle):
    """mjpc::ThreadPool semantics: Schedule / WaitCount / ResetCount."""

    _free = "threadpool_destroy"

    def __init__(self, n_workers: int):
        self._lib = load()
        self._p = self._lib.threadpool_create(n_workers)
        self._refs = []  # keep callbacks alive

    def schedule(self, fn):
        cb = TASK_FN(lambda _arg: fn())
        self._refs.append(cb)
        self._lib.threadpool_schedule(
            self._p, ctypes.cast(cb, ctypes.c_void_p), None)

    def wait_count(self, n: int):
        self._lib.threadpool_wait_count(self._p, n)
        self._refs.clear()

    def reset_count(self):
        self._lib.threadpool_reset_count(self._p)

    @property
    def count(self) -> int:
        return self._lib.threadpool_count(self._p)


class NativeStateStore(_Handle):
    """mjpc::State semantics: thread-safe (qpos, qvel, time) snapshots,
    float64."""

    _free = "state_destroy"

    def __init__(self, nq: int, nv: int):
        self._lib = load()
        self._nq, self._nv = nq, nv
        self._p = self._lib.state_create(nq, nv)

    def set(self, qpos, qvel, time: float):
        import numpy as np
        qp = np.ascontiguousarray(qpos, dtype=np.float64)
        qv = np.ascontiguousarray(qvel, dtype=np.float64)
        self._lib.state_set(
            self._p, qp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            qv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(time))

    def get(self):
        import numpy as np
        qp = np.empty(self._nq, dtype=np.float64)
        qv = np.empty(self._nv, dtype=np.float64)
        t = self._lib.state_get(
            self._p, qp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            qv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return qp, qv, t

    @property
    def version(self) -> int:
        return self._lib.state_version(self._p)


class NativePolicyBuffer(_Handle):
    """Double-buffered policy blob (bytes) with an atomic swap."""

    _free = "policy_destroy"

    def __init__(self):
        self._lib = load()
        self._p = self._lib.policy_create()

    def publish(self, blob: bytes):
        self._lib.policy_publish(self._p, blob, len(blob))

    def read(self):
        """The latest blob, or None before the first publish. The size
        is read apart from the blob, so a larger blob published between
        the two would be cut short: read into room to spare, and again
        when it was filled."""
        n = self._lib.policy_size(self._p)
        if n == 0:
            return None
        while True:
            cap = 2 * n + 1024
            buf = ctypes.create_string_buffer(cap)
            got = self._lib.policy_read(self._p, buf, cap)
            if got < cap:
                return buf.raw[:got]
            n = got

    @property
    def version(self) -> int:
        return self._lib.policy_version(self._p)


class NativeAgentLoop(_Handle):
    """Background plan loop (Agent::Plan busy loop, agent.cc:318-329) on
    a native std::thread, calling back into Python once an iteration.

    An exception raised by `plan_once` stops the loop and is kept in
    `error`; `stop()` re-raises it (the JAX loop drops it silently)."""

    _free = "agentloop_destroy"

    def __init__(self):
        self._lib = load()
        self._p = self._lib.agentloop_create()
        self._cb = None
        self.error = None

    def start(self, plan_once):
        """plan_once() -> bool (True = stop)."""
        def _cb(_ctx):
            try:
                return 1 if plan_once() else 0
            except Exception as e:   # noqa: BLE001, kept for stop()
                self.error = e
                return 1
        self.error = None
        self._cb = PLAN_CB(_cb)
        self._lib.agentloop_start(
            self._p, ctypes.cast(self._cb, ctypes.c_void_p), None)

    def stop(self):
        """Stop the loop and join its thread (the iteration in flight
        finishes first); re-raise the exception that ended it, if any."""
        self._lib.agentloop_stop(self._p)
        if self.error is not None:
            raise RuntimeError("the plan loop failed") from self.error

    @property
    def iterations(self) -> int:
        return self._lib.agentloop_iterations(self._p)
