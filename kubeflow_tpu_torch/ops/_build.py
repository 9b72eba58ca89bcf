"""Build ``ops/csrc/*.cu`` into shared libraries at first use.

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``kubeflow_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads from disk. A failed
build raises with the compiler's output.

Every ``nvcc`` that runs to a library is announced to ``listeners`` (a
plain list of callables, each called with one :class:`BuildEvent`): the
compile the port pays, which ``obs/xprof.py:CompileLedger`` records. A
library found on disk is no compile and announces nothing. A listener
that raises is logged and never fails the build.

Nothing here runs at import: the CPU tests import every module, and a
machine without CUDA never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildEvent:
    """One ``nvcc`` run that produced a library: ``seconds`` is that
    process's wall (its start to its exit; the builds of one
    :func:`build` call run in parallel, so their intervals overlap),
    ``start``/``end`` the same interval on the epoch clock, and
    ``fingerprint`` the library's digest (the hash in its file name)."""

    name: str
    fingerprint: str
    seconds: float
    start: float
    end: float


# callables taking one BuildEvent, called after each library is in place
listeners: List[Callable[[BuildEvent], None]] = []

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "kubeflow_tpu_torch need the CUDA toolkit")
    return path


def _target(name: str, build_dir: Optional[str] = None
            ) -> Tuple[str, str, str]:
    """``(source, library path, digest)`` of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    # the source, then every shared header it may include (csrc/*.cuh)
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return src, os.path.join(build_dir or BUILD_DIR,
                             f"lib{name}-{digest}.so"), digest


class _Job:
    """One running ``nvcc``; a thread drains its output and stamps the
    moment it exits, whichever job :func:`build` waits on first."""

    def __init__(self, cmd: List[str], tmp: str, out: str,
                 digest: str) -> None:
        self.tmp, self.out, self.digest = tmp, out, digest
        self.start = time.time()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.log = ""
        self.seconds = 0.0
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self.log, _ = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0

    def join(self) -> None:
        self._waiter.join()


def _start(name: str, build_dir: Optional[str] = None) -> Optional[_Job]:
    """Launch one ``nvcc`` for ``name`` (None when already built)."""
    src, out, digest = _target(name, build_dir)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    return _Job([_nvcc(), *NVCC_FLAGS, "-o", tmp, src], tmp, out, digest)


def _finish(name: str, job: Optional[_Job]) -> None:
    if job is None:
        return
    job.join()
    _logs[name] = job.log
    if job.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {job.proc.returncode}):\n{job.log}")
    os.replace(job.tmp, job.out)
    event = BuildEvent(name=name, fingerprint=job.digest,
                       seconds=job.seconds, start=job.start,
                       end=job.start + job.seconds)
    for listener in list(listeners):
        try:
            listener(event)
        except Exception:  # noqa: BLE001 — a listener never fails a build
            log.exception("build listener failed for %s (continuing)",
                          name)


def build(names: Iterable[str], build_dir: Optional[str] = None
          ) -> Dict[str, str]:
    """Compile every named source in parallel (one ``nvcc`` each, all
    started together) into ``build_dir`` (default ``BUILD_DIR``);
    returns each build's compiler log (ptxas register/shared-memory
    lines), empty for a cached library."""
    names = list(names)
    with _lock:
        jobs: List = [(n, _start(n, build_dir)) for n in names]
        errors = []
        for n, job in jobs:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _logs.get(n, "") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_target(name)[1])
        return _libs[name]
