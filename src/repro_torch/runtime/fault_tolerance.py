"""Fault-tolerant step loop: checkpoint/restart with bounded retries —
the port's copy of ``repro/runtime/fault_tolerance.py``.

``run_resilient`` wraps any (state, batch) -> (state, metrics) step: on
an exception (device loss, preemption — injected in tests via a failure
hook) it restores the last complete checkpoint, rebuilds the step
(``on_restart``) and replays from the restored step.  Data is
step-indexed and deterministic (:mod:`repro_torch.data.synthetic`), so
replays consume identical batches.  A step-0 checkpoint is written
first, so recovery never needs ``init_state``'s tensors, which the
trainer's step updates in place.  ``step_times`` are host-clock seconds
from drawing the batch to the step's return.

On a mesh the step function says where the state's blocks lie (its
``layout``: ``launch.train.MeshStep``).  Every rank runs the loop; the
checkpoints hold whole leaves (``checkpointer``, written by rank 0).
After a failure ``on_restart(restarts)`` may return the step of a new
mesh (``runtime.elastic.plan_remesh`` chooses it): the newest
checkpoint's whole leaves are read by the manifest's shapes, not by
``init_state``'s blocks (cut for the old mesh), and resharded onto the
new step's layout with ``runtime.elastic.reshard_state``; the saves go
on from there in the new layout.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ResilienceConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    async_save: bool = True
    keep: int = 3


@dataclasses.dataclass
class RunReport:
    final_state: Any
    steps_done: int
    restarts: int
    failures: list
    step_times: list
    #: worker seconds of each asynchronous save (to the host, then disk)
    save_seconds: list = dataclasses.field(default_factory=list)


def run_resilient(init_state: Any,
                  step_fn: Callable[[Any, Any], tuple[Any, dict]],
                  make_batch: Callable[[int], Any],
                  n_steps: int,
                  cfg: ResilienceConfig,
                  *,
                  failure_hook: Callable[[int], None] | None = None,
                  on_restart: Callable[[int], Callable] | None = None,
                  metrics_cb: Callable[[int, dict], None] | None = None,
                  clock: Callable[[], float] = time.perf_counter
                  ) -> RunReport:
    def restore(layout):
        if layout is None:
            return ckpt.restore_latest(cfg.ckpt_dir, init_state)
        found = ckpt.restore_latest(cfg.ckpt_dir, init_state, whole=True)
        if found is None:
            return None
        whole, at = found
        return reshard_state(whole, layout.mesh, layout.fsdp,
                             layout.moe_ep_data), at

    def saver_for(layout):
        return ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep,
                                      layout=layout) \
            if cfg.async_save else None

    layout = getattr(step_fn, "layout", None)
    state = init_state
    start = 0
    restored = restore(layout)
    # every rank has looked for a checkpoint before rank 0 writes one
    ckpt.barrier(layout)
    if restored is not None:
        state, start = restored
        log.info("resumed from step %d", start)
    else:
        # seed a step-0 checkpoint so recovery never needs the initial
        # tensors (the step updates them in place)
        ckpt.save(cfg.ckpt_dir, 0, init_state, layout=layout)
    saver = saver_for(layout)
    save_seconds: list = []
    monitor = StragglerMonitor()
    restarts = 0
    failures: list = []
    step = start
    try:
        while step < n_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                t0 = clock()
                batch = make_batch(step)
                state, metrics = step_fn(state, batch)
                dt = clock() - t0
                monitor.record(step, dt)
                if metrics_cb:
                    metrics_cb(step, metrics)
                step += 1
                if step % cfg.ckpt_every == 0 or step == n_steps:
                    if saver is not None:
                        saver.submit(step, state)
                    else:
                        ckpt.save(cfg.ckpt_dir, step, state, layout=layout)
            except Exception as e:  # noqa: BLE001 - deliberate catch-all
                failures.append((step, repr(e)))
                restarts += 1
                if restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={cfg.max_restarts}"
                    ) from e
                log.warning("step %d failed (%r); restarting (%d/%d)",
                            step, e, restarts, cfg.max_restarts)
                if saver is not None:
                    saver.wait()
                if on_restart is not None:
                    step_fn = on_restart(restarts)
                    new_layout = getattr(step_fn, "layout", None)
                    if new_layout is not layout and saver is not None:
                        saver.close()
                        save_seconds += saver.save_seconds
                        saver = saver_for(new_layout)
                    layout = new_layout
                restored = restore(layout)
                if restored is not None:
                    state, step = restored
                else:
                    state, step = init_state, 0
    finally:
        if saver is not None:
            saver.submit(step, state)
            saver.wait()
            saver.close()
            save_seconds += saver.save_seconds
    return RunReport(final_state=state, steps_done=step,
                     restarts=restarts, failures=failures,
                     step_times=monitor.times,
                     save_seconds=save_seconds)
