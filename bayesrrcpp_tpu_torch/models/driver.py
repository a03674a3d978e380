"""Chain driver: burn-in and thinned-emission scheduling.

Counterpart of ``bayesrrcpp_tpu/models/driver.py``, with the reference's
emission predicate ``iteration >= burn_in and iteration % thinning == 0``
(src/BayesRv2.cpp:257-272).  One emission chunk stays in flight: the steps
of chunk k+1 are enqueued on the device before chunk k's rows are read on
the host.  On CUDA each chunk's rows are copied into pinned host buffers
with ``non_blocking=True`` and an event is recorded after the copies, so
the host waits only for that event -- never for the steps behind it --
while it formats and writes chunk k.
"""
from __future__ import annotations

import numpy as np
import torch


def _stage(rows):
    """Start the device-to-host copy of a chunk's rows; returns a callable
    that waits for the copy and yields NumPy arrays."""
    tensors = {k: v for k, v in rows.items() if isinstance(v, torch.Tensor)}
    cuda = [v for v in tensors.values() if v.device.type == "cuda"]
    if not cuda:
        host = {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
                for k, v in rows.items()}
        return lambda: host
    host = dict(rows)
    for k, v in tensors.items():
        buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        buf.copy_(v, non_blocking=True)
        host[k] = buf
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(cuda[0].device))

    def wait():
        event.synchronize()
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in host.items()}

    return wait


def run_chain(state, chain, *, steps_fn, emit_fn, sink=None, collect=True,
              emit_chunk=32, start_iteration=0, progress=None,
              on_chunk=None, refresh_fn=None):
    """Drive a full chain.

    steps_fn(state, n)           -- advance n iterations.
    emit_fn(state, n, thinning)  -- n emissions of ``thinning`` steps each;
                                    returns (state, rows) with rows a dict
                                    of tensors stacked over the n emissions.
    progress(done, total)        -- optional callback per delivered chunk.
    on_chunk(state, done)        -- optional callback per delivered chunk
                                    with the newest state: that of the
                                    newest enqueued chunk, one chunk ahead
                                    of the rows delivered (periodic
                                    checkpoints; the generator that drew
                                    its steps is at the same point, since
                                    a draw advances it when it is
                                    enqueued).
    refresh_fn(state)            -- exact-residual recompute, applied every
                                    chain.eps_refresh_every iterations at
                                    the nearest chunk boundary.
    Returns (state, collected rows or None).
    """
    emits = list(chain.emit_iterations())
    collected = [] if collect else None
    total = len(emits)
    every = chain.eps_refresh_every
    last_refresh = start_iteration

    def maybe_refresh(state, it_now):
        nonlocal last_refresh
        if refresh_fn is None or not every or it_now - last_refresh < every:
            return state
        last_refresh = it_now
        return refresh_fn(state)

    def deliver(wait, done, state):
        rows = wait()
        if collected is not None:
            collected.append(rows)
        if sink is not None:
            sink.write(rows)
        if progress is not None:
            progress(done, total)
        if on_chunk is not None:
            on_chunk(state, done)

    if not emits:
        state = steps_fn(state, chain.max_iterations - start_iteration)
    else:
        pre = emits[0] + 1 - start_iteration
        if pre > 0:
            state = steps_fn(state, pre)
        state = maybe_refresh(state, emits[0] + 1)
        state, first = emit_fn(state, 1, 0)
        pending = (_stage(first), 1)
        done = 1
        while done < total:
            state = maybe_refresh(state, emits[done - 1] + 1)
            n = min(emit_chunk, total - done)
            state, rows = emit_fn(state, n, chain.thinning)
            done += n
            deliver(*pending, state)
            pending = (_stage(rows), done)
        deliver(*pending, state)
        tail = chain.max_iterations - (emits[-1] + 1)
        if tail > 0:
            state = steps_fn(state, tail)
    if sink is not None:
        sink.flush()
    out = None
    if collect:
        out = ({k: np.concatenate([c[k] for c in collected], axis=0)
                for k in collected[0]} if collected else {})
    return state, out
