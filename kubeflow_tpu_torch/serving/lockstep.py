"""Lockstep serving over a mesh: rank 0 plans, every rank runs.

The reference serves a model split over a mesh from one process: GSPMD
runs each engine program on every chip of the mesh
(``kubeflow_tpu/serving/engine.py:282``, ``server.py:1082``). The port
runs one process a rank, so it serves in lockstep:

- rank 0, the leader, runs the front ends and the scheduler. Before each
  program on the split model (a prefill, a prefill chunk, a decode round,
  a cache rebuild, a page-table write, a load, an engine stop) it
  broadcasts the program's plan: its name and its host arguments;
- every other rank, a follower, receives the plan and runs the same
  program on its own shard (``serving/server.py:serve_follower``), so
  every rank issues the same collectives in the same order, and samples
  the same tokens from the same gathered logits with the same seeds.

:meth:`Lockstep.program` is the leader's side: a context that sends the
plan, then holds the channel's lock while the leader runs the program
(two threads' collectives must never interleave). It is re-entrant: a
program started inside another sends nothing, as the followers run the
outer one whole. :meth:`Lockstep.recv` is the follower's side.

Every wait has a limit. A follower waits at most ``timeout_s`` for a
plan; an idle leader sends a ``noop`` plan every second, so an
idle server never times its followers out, and a follower whose leader
died ends with an error. A send that fails (a follower gone) sets
:attr:`Lockstep.broken` and raises; the server exits on it. A failed
collective is never caught here.

A plan is the pickled tuple ``(op, *args)`` as a uint8 tensor, its
length sent first: the ranks of one serving job trust each other.
"""

from __future__ import annotations

import contextlib
import datetime
import pickle
import threading
import time
from typing import Any, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

LEADER = 0
HEARTBEAT_S = 1.0       # an idle leader's plan interval


class Lockstep:
    """The plan channel over every rank of the default process group
    (see the module docstring). ``device`` is where the plan tensors
    live: the rank's card under NCCL, the CPU under gloo."""

    def __init__(self, *, device=None, timeout_s: float = 300.0) -> None:
        self.rank = tdist.get_rank()
        nccl = tdist.get_backend() == "nccl"
        self.device = torch.device(device if nccl else "cpu")
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.broken = threading.Event()
        self.plans_sent = 0
        self._lock = threading.RLock()
        self._depth = threading.local()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._beat = None
        if self.is_leader:
            self._beat = threading.Thread(target=self._heartbeat,
                                          daemon=True,
                                          name="lockstep-heartbeat")
            self._beat.start()

    @property
    def is_leader(self) -> bool:
        return self.rank == LEADER

    def _broadcast(self, t: torch.Tensor) -> None:
        work = tdist.broadcast(t, src=LEADER, async_op=True)
        work.wait(timeout=self.timeout)

    def _send(self, op: str, args: Sequence[Any]) -> None:
        w = torch.from_numpy(np.frombuffer(
            pickle.dumps((op, *args)), np.uint8).copy())
        try:
            self._broadcast(torch.tensor([w.numel()],
                                         device=self.device))
            self._broadcast(w.to(self.device))
        except Exception:
            self.broken.set()
            raise
        self.plans_sent += 1
        self._last = time.monotonic()

    @contextlib.contextmanager
    def program(self, op: str, *args) -> Iterator[None]:
        """The leader's side of one program: the plan ``(op, *args)``
        goes to every follower (unless a program is already running on
        this thread), then the body runs under the channel's lock."""
        if not self.is_leader:
            raise RuntimeError("only the leader (rank 0) plans")
        with self._lock:
            depth = getattr(self._depth, "n", 0)
            if depth == 0:
                if self.broken.is_set():
                    raise RuntimeError("lockstep channel broken: a "
                                       "follower is gone")
                self._send(op, args)
            self._depth.n = depth + 1
            try:
                yield
            finally:
                self._depth.n = depth

    def recv(self) -> Tuple[str, Tuple[Any, ...]]:
        """A follower's next plan ``(op, args)``; raises when none comes
        within ``timeout_s`` or the leader is gone."""
        n = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._broadcast(n)
        w = torch.empty(int(n.item()), dtype=torch.uint8,
                        device=self.device)
        self._broadcast(w)
        op, *args = pickle.loads(w.cpu().numpy().tobytes())
        return op, tuple(args)

    def _heartbeat(self) -> None:
        while not self._stop.wait(HEARTBEAT_S / 4):
            if time.monotonic() - self._last < HEARTBEAT_S:
                continue
            try:
                with self.program("noop"):
                    pass
            except Exception:  # noqa: BLE001 — broken is set; main exits
                return

    def stop(self) -> None:
        """The leader's last plan: every follower's serve loop returns."""
        self._stop.set()
        if self._beat is not None:
            self._beat.join()
        if not self.broken.is_set():
            with self.program("stop"):
                pass
