"""Shuffled shard loader (native-accelerated) and the device feed.

PyTorch port of ``kubeflow_tpu/data/loader.py``. Data format: a directory
of ``*.f32`` shard files, each a raw little-endian float32 array of
fixed-length records (``record_len`` floats a record);
:func:`write_shards` and :func:`read_shards` write and read them.

Two interchangeable loaders with the same epoch semantics (a seeded
permutation per epoch, drop-remainder batching):

- :class:`DataLoader`: a ctypes front end to the C++ threaded batcher
  (``data/dataloader.cc``), built with ``g++ -O2 -shared -fPIC`` at
  first use into ``kubeflow_tpu_torch/_build/``; ``.native`` says
  whether it runs. Where the library cannot be built or loaded it falls
  back to the Python twin, as the reference does.
- :class:`PyDataLoader`: the pure-Python twin (numpy ``default_rng(seed
  + epoch)``), the reference's batch for batch.

:func:`device_feed` turns either into a device iterator on one explicit
device, or, given the mesh as the reference's takes it, on this rank's
device with each rank's rows of the global batch: on CUDA, batch k+1 is
copied from pinned host memory on a side stream while the caller's step
runs on batch k, and a batch reaches the caller only after the compute
stream waits on its copy's event.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

SHARD_SUFFIX = ".f32"

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "dataloader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def shard_path(root: str, index: int) -> str:
    """The canonical shard filename, shared by the writer and reader."""
    return os.path.join(root, f"shard-{index:05d}{SHARD_SUFFIX}")


def write_shards(path: str, records: np.ndarray, *,
                 shards: int = 1) -> list:
    """Write ``(N, record_len)`` float32 ``records`` as raw shard files."""
    records = np.ascontiguousarray(records, dtype=np.float32)
    if records.ndim != 2:
        raise ValueError(f"records must be (N, record_len), got "
                         f"{records.shape}")
    os.makedirs(path, exist_ok=True)
    out = []
    for i, part in enumerate(np.array_split(records, shards)):
        fname = shard_path(path, i)
        part.tofile(fname)
        out.append(fname)
    return out


def read_shards(path: str, record_len: int) -> np.ndarray:
    """All shards concatenated as one ``(N, record_len)`` float32 array."""
    parts = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(SHARD_SUFFIX):
            continue
        raw = np.fromfile(os.path.join(path, fname), dtype=np.float32)
        if raw.size % record_len:
            raise ValueError(
                f"{fname}: {raw.size} floats not divisible by "
                f"record_len={record_len}")
        parts.append(raw.reshape(-1, record_len))
    if not parts:
        raise FileNotFoundError(f"no {SHARD_SUFFIX} shards in {path}")
    return np.concatenate(parts, axis=0)


def _check_batch(batch: int, n_records: int) -> None:
    if not 0 < int(batch) <= n_records:
        raise ValueError(
            f"batch {batch} must be in [1, {n_records}] "
            "(drop-remainder batching needs at least one full batch)")


class PyDataLoader:
    """The pure-Python twin: seeded per-epoch shuffle, drop-remainder."""

    def __init__(self, records: np.ndarray, batch: int,
                 seed: int = 0) -> None:
        self.records = np.ascontiguousarray(records, dtype=np.float32)
        _check_batch(batch, len(self.records))
        self.batch = int(batch)
        self.seed = int(seed)
        self._epoch = 0
        self._cursor = 0
        self._perm = self._shuffle()

    def _shuffle(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        return rng.permutation(len(self.records))

    def next(self) -> Tuple[np.ndarray, int]:
        if self._cursor + self.batch > len(self.records):
            self._epoch += 1
            self._perm = self._shuffle()
            self._cursor = 0
        idx = self._perm[self._cursor:self._cursor + self.batch]
        self._cursor += self.batch
        return self.records[idx], self._epoch

    def close(self) -> None:
        pass


def _library_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libdataloader-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native loader build unavailable (%s); using the "
                    "Python twin", e)
        return False
    if proc.returncode != 0:
        log.warning("native loader build failed; using the Python twin:\n"
                    "%s", proc.stderr[-800:])
        return False
    os.replace(tmp, out)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """The native batcher, built at first use; None where it cannot be
    built or loaded (the loaders then run the Python twin)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _library_path()
        try:
            if not os.path.exists(path) and not _build(path):
                _load_failed = True
                return None
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning("could not load the native loader (%s); using the "
                        "Python twin", e)
            _load_failed = True
            return None
        lib.kftpu_loader_create.restype = ctypes.c_void_p
        lib.kftpu_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64,
        ]
        lib.kftpu_loader_next.restype = ctypes.c_int64
        lib.kftpu_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.kftpu_loader_ready.restype = ctypes.c_int32
        lib.kftpu_loader_ready.argtypes = [ctypes.c_void_p]
        lib.kftpu_loader_destroy.restype = None
        lib.kftpu_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class DataLoader:
    """The native threaded batcher over in-memory records; the Python
    twin where the library is unavailable (``native`` False)."""

    def __init__(self, records: np.ndarray, batch: int, *, seed: int = 0,
                 n_threads: int = 2, pool_size: int = 4) -> None:
        self.records = np.ascontiguousarray(records, dtype=np.float32)
        if self.records.ndim != 2:
            raise ValueError("records must be (N, record_len)")
        # checked here: a null handle from create would otherwise pass
        # for a missing toolchain, and both loaders refuse alike
        _check_batch(batch, len(self.records))
        if int(n_threads) < 1 or int(pool_size) < 2:
            raise ValueError("need n_threads >= 1 and pool_size >= 2")
        self.batch = int(batch)
        self.record_len = self.records.shape[1]
        self._lib = load_library()
        self._handle = None
        self._fallback: Optional[PyDataLoader] = None
        if self._lib is not None:
            # the native loader BORROWS self.records' buffer: this object
            # keeps the array alive until close()
            self._handle = self._lib.kftpu_loader_create(
                self.records.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.records.shape[0], self.record_len, self.batch,
                int(n_threads), int(pool_size), int(seed))
        if self._handle:
            self._out = np.empty((self.batch, self.record_len), np.float32)
        else:
            self._handle = None
            self._fallback = PyDataLoader(self.records, batch, seed=seed)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def next(self) -> Tuple[np.ndarray, int]:
        """(a copy of the batch, its epoch); blocks until one is ready."""
        if self._fallback is not None:
            return self._fallback.next()
        epoch = self._lib.kftpu_loader_next(
            self._handle,
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if epoch < 0:
            raise RuntimeError("loader shut down")
        return self._out.copy(), int(epoch)

    def ready(self) -> int:
        if self._fallback is not None:
            return 0
        return int(self._lib.kftpu_loader_ready(self._handle))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.kftpu_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "DataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort: joins the producer threads
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def device_feed(loader, device, *, reshape=None,
                transform: Optional[Callable[[np.ndarray], Any]] = None,
                steps: Optional[int] = None) -> Iterator:
    """A device iterator over ``loader``'s batches: batch k+1 is copied
    to ``device`` while the caller computes on batch k.

    ``device`` may be the mesh (``parallel/mesh.py:create_mesh``), as
    the reference's ``device_feed(loader, mesh)`` takes it: every rank's
    loader yields the same global batch (the same seed), each rank keeps
    its rows over the ``batch`` rule's axes on the host, so only they
    cross, and each leaf lands on this rank's device wrapped as its rows
    (``parallel/mesh.py:RankRows``): a train step over the mesh takes
    them as they are. The pipelined step takes a global batch at dp > 1
    (its microbatches are the global batch's), so feed it a device.

    ``reshape`` and then ``transform`` run on the HOST before the copy;
    ``transform`` may return an array or a tuple, list or dict of arrays
    or tensors (split the labels out, cast the pixels to bf16 so half
    the bytes cross). Each leaf lands on ``device`` as a tensor.

    On CUDA each batch is pinned (PyTorch's caching host allocator,
    which hands a pinned block out again only after the copies recorded
    on it have completed; the feed also keeps it referenced until its
    batch is handed over) and copied with ``non_blocking=True`` on a
    side stream that records an event; before a batch is yielded the
    current stream waits on that event, and each tensor is marked as
    used there (``record_stream``) so its memory is not reused while the
    step still reads it. With ``steps`` the feed consumes exactly
    ``steps`` batches from the loader."""
    from kubeflow_tpu_torch.parallel import mesh as pmesh

    mesh = device if hasattr(device, "mesh_dim_names") else None
    if mesh is not None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if mesh.device_type == "cuda" else "cpu")
        rows = pmesh.PartitionSpec(pmesh.batch_axes())
        n = pmesh.axis_size(mesh, rows[0])
    dev = torch.device(device)

    def mine(t):
        if t.shape[0] % n:
            raise ValueError(f"global batch {t.shape[0]} does not divide "
                             f"over {n} data-parallel ranks")
        return pmesh.local_block(t, rows, mesh).contiguous()

    def host(arr):
        if reshape is not None:
            arr = arr.reshape(reshape)
        if transform is not None:
            arr = transform(arr)
        arr = _tree_map(torch.as_tensor, arr)
        return _tree_map(mine, arr) if mesh is not None else arr

    def marked(out):
        return _tree_map(pmesh.RankRows, out) if mesh is not None else out

    if dev.type == "cuda":
        stream = torch.cuda.Stream(dev)

        def put(arr):
            pinned = _tree_map(lambda t: t.pin_memory(), host(arr))
            with torch.cuda.stream(stream):
                out = _tree_map(lambda t: t.to(dev, non_blocking=True),
                                pinned)
                done = torch.cuda.Event()
                done.record(stream)
            return out, pinned, done

        def hand_over(batch):
            out, _, done = batch
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for t in _leaves(out):
                t.record_stream(current)
            return marked(out)
    else:
        def put(arr):
            return _tree_map(lambda t: t.to(dev), host(arr))

        def hand_over(batch):
            return marked(batch)

    if steps is not None and steps <= 0:
        return
    pending = put(loader.next()[0])  # prime the double buffer
    produced = 0
    while True:
        produced += 1
        if steps is not None and produced >= steps:
            # the last batch: no lookahead, so a finite feed consumes
            # exactly `steps` batches from the loader
            yield hand_over(pending)
            return
        nxt = put(loader.next()[0])  # the next copy is issued...
        yield hand_over(pending)      # ...while the caller computes
        pending = nxt
