"""Batch assembly in a spawned process, batches over shared memory.

A jax-free copy of sniper_tpu/data/shm_loader.py:1-262 around the port's
ChipLoader (TRAIN.LOADER_PROCESS). The training interpreter's own threads
(batch assembly, upload, the step's eager dispatch) share one interpreter
lock; this module moves the whole ChipLoader into a child process, so that
the parent only copies finished batches out of shared memory.
``ProcessChipLoader`` has the surface ``run_training`` uses: ``reset``,
``__len__``, ``__iter__``, ``batches`` and ``close``.

Protocol (one duplex pipe; depth + 1 shared-memory slots allocated on the
first non-empty epoch from the first batch's byte size: shapes are static,
so every batch fits):

  ("reset",)  -> ("reset", n_chips)
  ("len",)    -> ("len", n_batches)
  ("epoch", limit) -> ("ready", nbytes | 0)   the epoch's first ``limit``
                 batches (all for None); nbytes > 0 asks for the slots;
                 the parent replies ("slots", [names]) then, and primes
                 depth + 1 free-slot ints. Per batch the child receives a
                 free slot int, writes the arrays and replies ("batch",
                 slot, meta); the parent copies the batch out and returns
                 the slot int. ("end",) closes the epoch, after which the
                 child drains exactly depth + 1 slot ints, so the pipe
                 carries no stale token into the next command.
  None        -> the child exits.

The child is spawned, never forked (the parent holds CUDA and threads), and
it hides the cards from itself before it builds the loader, so it can
never initialise CUDA. Its exceptions arrive as ("error", traceback) and
re-raise in the parent. An epoch cut short on purpose is asked for as
``batches(limit)`` (``run_training`` cuts each epoch to the ranks' global
minimum of steps and to ``max_steps``): the child stops after ``limit``
batches and closes the epoch itself, as the in-process loader's
``batches(limit)`` does. An epoch abandoned before its end (the iterator
closed early, on an error) leaves the protocol mid-batch: the child is
killed, and the next call respawns it and replays one reset. A respawned
child's rng restarts, so after an abandoned epoch the chip rolls no longer
follow the in-process loader's.
The injected ``image_loader`` is pickled to the child: it must be a
module-level function.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from multiprocessing import shared_memory

import numpy as np

_CTX = mp.get_context("spawn")


def _child_main(conn, spec, depth):
    """Child entry: run the port's ChipLoader, stream batches into the
    shared-memory slots."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    slots: list = []
    try:
        from sniper_tpu_torch.data.loader import ChipLoader, load_image_cv2

        roidb, cfg, batch_size, seed, image_loader = spec
        loader = ChipLoader(roidb, cfg, batch_size, seed=seed,
                            image_loader=image_loader or load_image_cv2)
        n_slots = depth + 1
        while True:
            msg = conn.recv()
            if msg is None:
                break
            if msg[0] == "reset":
                conn.send(("reset", loader.reset()))
            elif msg[0] == "len":
                conn.send(("len", len(loader)))
            elif msg[0] == "epoch":
                it = loader.batches(msg[1])
                first = next(it, None)
                if first is not None and not slots:
                    total = sum(v.nbytes for v in first.values())
                    conn.send(("ready", total))
                    names = conn.recv()[1]
                    slots = [shared_memory.SharedMemory(name=n)
                             for n in names]
                else:
                    conn.send(("ready", 0))

                def ship(batch):
                    slot = conn.recv()  # a free slot int
                    meta, off = [], 0
                    for k, v in batch.items():
                        v = np.ascontiguousarray(v)
                        dst = np.ndarray(v.shape, v.dtype,
                                         buffer=slots[slot].buf, offset=off)
                        dst[...] = v
                        meta.append((k, v.dtype.str, v.shape, off))
                        off += v.nbytes
                    conn.send(("batch", slot, meta))

                if first is not None:
                    ship(first)
                    for batch in it:
                        ship(batch)
                conn.send(("end",))
                # the parent primed n_slots ints and returned one per
                # batch: exactly n_slots are in flight at the epoch's end
                for _ in range(n_slots):
                    conn.recv()
    except BaseException:  # noqa: BLE001 - re-raised in the parent
        try:
            conn.send(("error", traceback.format_exc()))
        except (BrokenPipeError, OSError):  # the parent is gone
            pass
    finally:
        for s in slots:
            s.close()
        conn.close()


class ProcessChipLoader:
    """A ChipLoader whose assembly runs in a spawned process (module doc)."""

    def __init__(self, roidb, cfg, batch_size, seed=0, depth=2,
                 image_loader=None):
        self.depth = depth
        # None selects the cv2 image reader in the child
        self._spec = (roidb, cfg, batch_size, seed, image_loader)
        self._slots: list[shared_memory.SharedMemory] = []
        self._len = 0
        self._was_reset = False
        self.conn = None
        self.proc = None
        self._spawn()

    def _spawn(self):
        self.conn, child_conn = _CTX.Pipe()
        self.proc = _CTX.Process(
            target=_child_main, args=(child_conn, self._spec, self.depth),
            daemon=True)
        self.proc.start()
        child_conn.close()

    def _ensure(self):
        if self.proc is None or not self.proc.is_alive():
            self._release_slots()
            self._spawn()
            # a respawned child re-derives the loader's state: replay one
            # reset so that a chip roll exists
            if self._was_reset:
                self.conn.send(("reset",))
                self._recv()

    def _recv(self):
        msg = self.conn.recv()
        if msg[0] == "error":
            raise RuntimeError(f"loader process failed:\n{msg[1]}")
        return msg

    def reset(self) -> int:
        self._ensure()
        self._was_reset = True
        self.conn.send(("reset",))
        n = self._recv()[1]
        self.conn.send(("len",))
        self._len = self._recv()[1]
        return n

    def __len__(self):
        if not self._len:
            self._ensure()
            self.conn.send(("len",))
            self._len = self._recv()[1]
        return self._len

    def __iter__(self):
        return self.batches()

    def batches(self, limit: int | None = None):
        """The epoch's batches, or its first ``limit``, which the child
        closes like a whole epoch (module doc)."""
        self._ensure()
        self.conn.send(("epoch", limit))
        msg = self._recv()
        if msg[0] != "ready":
            raise RuntimeError(f"loader process protocol: {msg[0]!r}")
        if msg[1]:
            self._release_slots()
            self._slots = [
                shared_memory.SharedMemory(create=True, size=msg[1])
                for _ in range(self.depth + 1)]
            self.conn.send(("slots", [s.name for s in self._slots]))
        for i in range(self.depth + 1):
            self.conn.send(i)
        complete = False
        try:
            while True:
                msg = self._recv()
                if msg[0] == "end":
                    complete = True
                    return
                _, slot, meta = msg
                buf = self._slots[slot].buf
                batch = {k: np.ndarray(shape, np.dtype(dt), buffer=buf,
                                       offset=off).copy()  # slot recycled
                         for k, dt, shape, off in meta}
                self.conn.send(slot)
                yield batch
        finally:
            if not complete:
                # abandoned mid-epoch: the child waits on a slot token
                self.proc.terminate()
                self.proc.join()

    def _release_slots(self):
        for s in self._slots:
            s.close()
            try:
                s.unlink()
            except FileNotFoundError:
                pass
        self._slots = []

    def close(self):
        """Stop the child and free the shared memory (idempotent)."""
        try:
            if self.proc is not None and self.proc.is_alive():
                self.conn.send(None)
                self.proc.join(timeout=5)
                if self.proc.is_alive():
                    self.proc.terminate()
                    self.proc.join()
        except (BrokenPipeError, OSError):
            pass
        self._release_slots()

    def __del__(self):
        self.close()
