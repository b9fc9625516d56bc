"""Fault tolerance, counterpart of ``repro.training.fault_tolerance``:
deterministic resume and straggler-aware shard scheduling.

* ``TrainingRunner``: a step loop with periodic (asynchronous)
  checkpoints and step-keyed deterministic data, so a crash at any step
  resumes from the last checkpoint to the same bits.
* ``ShardScheduler``: over-decomposed data shards with heartbeat-based
  reassignment on an injected clock: a straggler's pending shards go back
  to the queue for healthy workers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from .checkpoint import CheckpointManager, latest_step

__all__ = ["TrainingRunner", "ShardScheduler", "WorkerState"]


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    assigned: list  # shard ids in flight


class ShardScheduler:
    """Over-decomposed shard assignment with straggler re-dispatch.

    A worker silent for longer than ``timeout`` (on the clock ``now``) gets
    its in-flight shards returned to the front of the queue.  Completed
    shards are idempotent (keyed by id), so a re-dispatched shard that
    finishes twice is safe.
    """

    def __init__(self, n_workers: int, n_shards: int, timeout: float = 5.0,
                 now: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.now = now
        self.workers = {
            w: WorkerState(w, self.now(), []) for w in range(n_workers)
        }
        self.pending = list(range(n_shards))
        self.done: set[int] = set()
        self.completed_by: dict[int, int] = {}

    def heartbeat(self, worker_id: int) -> None:
        self.workers[worker_id].last_heartbeat = self.now()

    def request_work(self, worker_id: int) -> Optional[int]:
        self.heartbeat(worker_id)
        self._reassign_stragglers()
        if not self.pending:
            return None
        shard = self.pending.pop(0)
        self.workers[worker_id].assigned.append(shard)
        return shard

    def complete(self, worker_id: int, shard: int) -> None:
        self.heartbeat(worker_id)
        if shard in self.done:
            return  # idempotent: re-dispatched shard finished twice
        self.done.add(shard)
        self.completed_by[shard] = worker_id
        for w in self.workers.values():
            if shard in w.assigned:
                w.assigned.remove(shard)

    def _reassign_stragglers(self) -> None:
        t = self.now()
        for w in self.workers.values():
            if t - w.last_heartbeat > self.timeout and w.assigned:
                # return the straggler's in-flight shards to the queue front
                for s in w.assigned:
                    if s not in self.done and s not in self.pending:
                        self.pending.insert(0, s)
                w.assigned.clear()

    @property
    def finished(self) -> bool:
        return len(self.done) >= len(self.completed_by) and not self.pending and all(
            not w.assigned for w in self.workers.values()
        )


class TrainingRunner:
    """Checkpointed step loop with deterministic resume.

    step_fn(state, batch) -> (state, metrics);  data_fn(step) -> batch must
    be a pure function of the step index (``data.pipeline`` is).  The
    history holds each step's metrics as Python floats.  ``writes=False``
    resumes from ``ckpt_dir`` but writes nothing there: the ranks of a mesh
    other than the one that saves, which take part in each save's gathers
    of a sharded state (``save_checkpoint(write=False)``).
    """

    def __init__(
        self,
        step_fn: Callable,
        data_fn: Callable[[int], Any],
        init_state: Any,
        ckpt_dir: str,
        ckpt_every: int = 10,
        keep_n: int = 3,
        codec: str | None = None,  # None = best available (zstd or none)
        fail_at: Optional[int] = None,  # test hook: simulated crash
        writes: bool = True,
    ):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.manager = CheckpointManager(ckpt_dir, keep_n=keep_n, codec=codec)
        self.ckpt_every = ckpt_every
        self.fail_at = fail_at
        self.writes = writes
        self.state = init_state
        self.start_step = 0
        if latest_step(self.manager.dir) is not None:
            self.state, self.start_step = self.manager.restore(init_state)
            self.start_step += 1

    def run(self, n_steps: int) -> list[dict]:
        history = []
        for step in range(self.start_step, n_steps):
            if self.fail_at is not None and step == self.fail_at:
                self.manager.wait()
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self.data_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
            if step % self.ckpt_every == 0:
                self.manager.save(step, self.state, asynchronous=True, write=self.writes)
        self.manager.wait()
        self.manager.save(n_steps - 1, self.state, asynchronous=False, write=self.writes)
        return history
