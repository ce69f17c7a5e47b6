"""Device-side timing by chained repetition.

Run the op K times inside ONE jitted program with a data dependence chained
through iterations (XLA cannot elide or overlap chained iterations), sync
once, and divide. Fixed dispatch and sync latency cancels in the K->2K
difference, and so does the cost of the cheap elementwise chain
perturbation.

time_chained(make_step, x, k) returns seconds per op instance:
  make_step: fn(carry_array) -> array of same shape/dtype (the op under test
             must dominate the step's cost).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp


def _chain(make_step, k: int):
    def run(x, *consts):
        def body(carry, _):
            return make_step(carry, *consts), None

        out, _ = jax.lax.scan(body, x, None, length=k)
        return out

    return jax.jit(run)


def time_chained(make_step, x, k: int = 16, reps: int = 3,
                 consts: tuple = ()) -> float:
    """Median seconds per op, measured as (T(2k) - T(k)) / k so fixed
    dispatch/sync latency cancels.

    Side operands the step needs (payload columns, lookup tables) go in
    ``consts`` — make_step is then called as make_step(carry, *consts) and
    they ride as jit ARGUMENTS. Closing over device arrays instead embeds
    them as HLO constants, and the compiled program then grows with the
    data."""
    import numpy as np

    def _sync(out):
        # a 1-element readback completes the program; its fixed latency
        # cancels in the K->2K difference
        return np.asarray(out.ravel()[:1])

    f1 = _chain(make_step, k)
    f2 = _chain(make_step, 2 * k)
    # warm both compiles
    _sync(f1(x, *consts))
    _sync(f2(x, *consts))

    def run(f):
        t0 = time.perf_counter()
        _sync(f(x, *consts))
        return time.perf_counter() - t0

    deltas = []
    for _ in range(reps):
        t1 = run(f1)
        t2 = run(f2)
        deltas.append((t2 - t1) / k)
    deltas.sort()
    return max(deltas[len(deltas) // 2], 1e-9)


def time_chained_multi(specs, reps: int = 3) -> dict:
    """Interleaved chained timing of SEVERAL candidates in one process.

    specs: list of (name, make_step, x, k) or (name, make_step, x, k,
    consts) — consts as in time_chained (jit arguments, not HLO-embedded
    closure constants). All K and 2K chains compile and
    warm first; measurement rounds then visit every candidate round-robin,
    so slow drift (host load, clock changes) lands evenly
    across candidates instead of in whichever ran last (separate calls
    minutes apart let drift land in the differences between them). Returns
    {name: median seconds per op}.
    """
    import numpy as np

    def _sync(out):
        return np.asarray(out.ravel()[:1])

    compiled = []
    for spec in specs:
        name, make_step, x, k = spec[:4]
        consts = spec[4] if len(spec) > 4 else ()
        f1, f2 = _chain(make_step, k), _chain(make_step, 2 * k)
        _sync(f1(x, *consts))
        _sync(f2(x, *consts))
        compiled.append((name, f1, f2, x, k, consts))

    deltas = {spec[0]: [] for spec in specs}
    for _ in range(reps):
        for name, f1, f2, x, k, consts in compiled:
            t0 = time.perf_counter()
            _sync(f1(x, *consts))
            t1 = time.perf_counter()
            _sync(f2(x, *consts))
            t2 = time.perf_counter()
            deltas[name].append(((t2 - t1) - (t1 - t0)) / k)
    out = {}
    for name, ds in deltas.items():
        ds.sort()
        out[name] = max(ds[len(ds) // 2], 1e-9)
    return out
