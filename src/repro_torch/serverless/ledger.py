"""Durable task-state ledger — checkpoint/restart for the estimation run.

The ledger *is* the fault-tolerance mechanism (DESIGN.md §4): completed
invocations' predictions are durable; a restart re-dispatches only the
missing ones; worker loss mid-wave just leaves PENDING entries behind.
Serialization is msgpack (no pickle: restart may happen on another host).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import msgpack
import numpy as np

PENDING, RUNNING, DONE, FAILED = 0, 1, 2, 3


@dataclass
class TaskLedger:
    n_invocations: int
    n_obs: int
    tasks_per_invocation: int            # K for 'n_rep' scaling, else 1
    status: np.ndarray                   # (n_inv,) int8
    preds: np.ndarray                    # (n_inv, tasks_per_inv, N) f32
    attempts: np.ndarray                 # (n_inv,) int16
    path: Optional[str] = None           # bound by durable sessions

    @classmethod
    def create(cls, n_invocations: int, n_obs: int,
               tasks_per_invocation: int) -> "TaskLedger":
        return cls(
            n_invocations=n_invocations,
            n_obs=n_obs,
            tasks_per_invocation=tasks_per_invocation,
            status=np.zeros(n_invocations, np.int8),
            preds=np.zeros((n_invocations, tasks_per_invocation, n_obs),
                           np.float32),
            attempts=np.zeros(n_invocations, np.int16),
        )

    # ---- state transitions ----
    def pending(self) -> np.ndarray:
        """Invocations still owed results (PENDING, FAILED-awaiting-retry,
        or RUNNING rows orphaned by a crashed drain)."""
        return np.where(self.status != DONE)[0]

    def mark_running(self, invs) -> None:
        """Flag dispatched rows so a checkpoint taken mid-wave re-queues
        exactly the in-flight work on restart (load() resets RUNNING)."""
        invs = np.asarray(invs, np.int64)
        self.status[invs[self.status[invs] != DONE]] = RUNNING

    def record_success(self, inv: int, preds: np.ndarray):
        self.preds[inv] = preds
        self.status[inv] = DONE

    def record_successes(self, invs, preds_rows: np.ndarray):
        """Batch form: one bucket launch landing many invocations."""
        invs = np.asarray(invs, np.int64)
        self.preds[invs] = preds_rows
        self.status[invs] = DONE

    def record_failure(self, inv: int):
        self.status[inv] = FAILED
        self.attempts[inv] += 1

    @property
    def complete(self) -> bool:
        return bool((self.status == DONE).all())

    @property
    def n_done(self) -> int:
        return int((self.status == DONE).sum())

    # ---- durability ----
    def save(self, path: str):
        payload = {
            "n_invocations": self.n_invocations,
            "n_obs": self.n_obs,
            "tasks_per_invocation": self.tasks_per_invocation,
            "status": self.status.tobytes(),
            "attempts": self.attempts.tobytes(),
            # only DONE rows are worth persisting
            "done_idx": np.where(self.status == DONE)[0].astype(np.int64)
                          .tobytes(),
            "done_preds": self.preds[self.status == DONE].tobytes(),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
        os.replace(tmp, path)            # atomic — a crash never corrupts

    def checkpoint(self) -> None:
        """Persist to the bound ``path`` (no-op for in-memory ledgers).
        Durable sessions bind the path at admission; backends call this
        after every booking wave, so a crash loses at most one wave of
        re-executable work and never a booked result."""
        if self.path is not None:
            self.save(self.path)

    @classmethod
    def load(cls, path: str) -> "TaskLedger":
        with open(path, "rb") as f:
            p = msgpack.unpackb(f.read(), raw=False)
        led = cls.create(p["n_invocations"], p["n_obs"],
                         p["tasks_per_invocation"])
        led.status = np.frombuffer(p["status"], np.int8).copy()
        led.attempts = np.frombuffer(p["attempts"], np.int16).copy()
        done_idx = np.frombuffer(p["done_idx"], np.int64)
        done = np.frombuffer(p["done_preds"], np.float32).reshape(
            len(done_idx), p["tasks_per_invocation"], p["n_obs"])
        led.preds[done_idx] = done
        # anything that was RUNNING when we died is re-dispatched
        led.status[led.status == RUNNING] = PENDING
        return led
