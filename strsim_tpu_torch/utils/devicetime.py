"""Device time per block of work on tensors already staged on the card.

    run(n)  = n calls of `fn`, over the staged blocks in turn (block i mod C),
              between two CUDA events;
    t_block = median over reps of (run(c2) - run(c1)) / (c2 - c1)

as `strsim_tpu/utils/devicetime.py:marginal_block_time` differences wall
times over two trip counts, so that a run's fixed costs (the events, the
first launch's gap) cancel. The host enqueues each run behind a sleep on the
card (`torch.cuda._sleep`) as long as its enqueue took before, so the card
finds the run's launches queued and the events see their device time, not
the host's launch pace. A call of `fn` that waits for the card on the host
breaks that queue; its gap then counts, as it would in a pass.

The XLA guards of the JAX version (a loop index XLA cannot hoist, two staged
chunks at least) have no counterpart: PyTorch runs each call as issued.
There is no CPU form: a CPU tensor has no device time, and this raises.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _check_on_card(blocks: Sequence[tuple]) -> torch.device:
    devices = {t.device for block in blocks for t in block if isinstance(t, torch.Tensor)}
    if not devices:
        raise ValueError("no staged tensors to time")
    if any(d.type != "cuda" for d in devices) or len(devices) != 1:
        raise ValueError(f"device time needs tensors on one CUDA device, got {sorted(map(str, devices))}")
    return devices.pop()


def _run_ms(fn: Callable, blocks: Sequence[tuple], trips: int, sleep_cycles: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for i in range(trips):
        fn(*blocks[i % len(blocks)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def marginal_block_time(fn: Callable, blocks: Sequence[tuple], c1: int = 2, c2: int = 10,
                        reps: int = 3, min_delta_ms: float = 2.0, max_trips: int = 4096,
                        clock_hz: float = 1.98e9) -> float:
    """Milliseconds of device time per call of `fn(*block)`, with `blocks`
    the staged tensors of each block (all on one CUDA device). Warms up with
    one call of each block first; raises on CPU tensors. The trip count c2
    grows until the difference clears `min_delta_ms` (or reaches max_trips).
    `clock_hz` converts the queueing sleep to cycles (the card's maximum SM
    clock; a higher clock only shortens the sleep)."""
    device = _check_on_card(blocks)
    with torch.cuda.device(device):
        for block in blocks:
            fn(*block)
        torch.cuda.synchronize()
        while True:
            t0 = time.perf_counter()
            for i in range(c2):  # the enqueue time of c2 calls sizes the sleep
                fn(*blocks[i % len(blocks)])
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            sleep_cycles = int(2 * enqueue_s * clock_hz) + 1000
            deltas = sorted(_run_ms(fn, blocks, c2, sleep_cycles) - _run_ms(fn, blocks, c1, sleep_cycles)
                            for _ in range(reps))
            delta = deltas[len(deltas) // 2]
            if delta >= min_delta_ms or c2 >= max_trips:
                return max(delta, 1e-9) / (c2 - c1)
            per_call = max(delta / (c2 - c1), 1e-4)
            c2 = min(max(int(min_delta_ms / per_call * 1.25) + c1, 2 * c2), max_trips)
