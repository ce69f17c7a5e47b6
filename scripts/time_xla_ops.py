#!/usr/bin/env python
"""Per-op device times of the plain XLA paths, beside a large-copy bandwidth
measured in the same process.

Each op runs at the sizes chip_smoke.py drives it at, on device-generated
data, timed by the host clock around block_until_ready after a warm-up
(bench.harness.time_fn, median of 10 calls). ``bytes`` counts every input
and output array once, except that a gather from a table counts only the
elements it reads; ``copy_share`` is (bytes / seconds) over the copy's
bytes/s, so 1.0 means the op moved its own inputs and outputs at copy speed.
Prints one JSON line per op, each naming the device. Exits non-zero without
a GPU.

    python scripts/time_xla_ops.py [--only REGEX]

This stands in for per-layer kernel times until the benchmark reads them
from a device trace; remove it then.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=".*")
    args = ap.parse_args()
    MI = 1 << 20
    pat = re.compile(args.only)

    import jax
    import jax.numpy as jnp

    from dpu_olap_tpu import backend
    from dpu_olap_tpu.bench.harness import time_fn
    from dpu_olap_tpu.ops.aggregate import sum_u64_pair
    from dpu_olap_tpu.ops.filter import filter_compact, filter_with_indices
    from dpu_olap_tpu.ops.hashtable import ht_build_sorted, ht_probe_sorted
    from dpu_olap_tpu.ops.join import _fill_forward, join_shard_dense, join_shard_fused
    from dpu_olap_tpu.ops.take import take
    from dpu_olap_tpu.parallel.shuffle import local_fragments

    dev = backend.require_gpu("time_xla_ops.py")[0]
    backend.use_compile_cache()
    key = jax.random.PRNGKey(0)

    def u32(n, salt, hi=None):
        bits = jax.random.bits(jax.random.fold_in(key, salt), (n,), jnp.uint32)
        return bits if hi is None else bits % jnp.uint32(hi)

    def nbytes(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree))

    def measure(fn, *xs):
        f = jax.jit(fn)
        out, first, sec = time_fn(lambda: f(*xs), reps=10)
        return sec, first, nbytes(xs) + nbytes(out)

    # large copy: read and write 1 GiB
    big = u32(256 * MI, 1)
    salt = jnp.uint32(1)
    copy_s, _, copy_bytes = measure(lambda x, c: x ^ c, big, salt)
    copy_bw = copy_bytes / copy_s
    del big
    print(json.dumps({
        "op": "copy_1GiB", "device_kind": dev.device_kind, "ms": copy_s * 1e3,
        "bytes": copy_bytes, "gb_per_s": copy_bw / 1e9,
    }), flush=True)

    def report(name, size, fn, *xs, moved=None):
        if not pat.search(name):
            return
        sec, first, b = measure(fn, *xs)
        b = b if moved is None else moved
        print(json.dumps({
            "op": name, "device_kind": dev.device_kind, "size": size,
            "ms": sec * 1e3, "first_s": first,
            "bytes": b, "gb_per_s": b / sec / 1e9, "copy_share": b / sec / copy_bw,
        }), flush=True)

    # join inputs: sequential pk (the reference), uniform fk
    for sf in (1, 8, 32):
        n = sf * 2 * MI
        pk = jnp.arange(n, dtype=jnp.uint32)
        x, y = u32(n, 10 + sf), u32(n, 20 + sf)
        fk = u32(n, 30 + sf, n)
        report(f"join_dense_sf{sf}", n, lambda a, b, c, d: join_shard_dense(a, (b,), c, (d,)),
               fk, y, pk, x)
        report(f"join_fused_keys31_sf{sf}", n,
               lambda a, b, c, d: join_shard_fused(a, (b,), c, (d,), keys31=True),
               fk, y, pk, x)
        # the plain versions of the removed kernels, at the generic join's
        # concat length (both sides)
        k2 = jnp.concatenate([pk << 1, (fk << 1) | 1])
        pay = jnp.concatenate([x, y])
        report(f"sort_2op_sf{sf}", 2 * n, lambda a, b: jax.lax.sort([a, b], num_keys=1), k2, pay)
        keyp = jnp.where(k2 & 1 == 0, k2 >> 1, jnp.uint32(0xFFFFFFFF))
        report(f"fill_2plane_sf{sf}", 2 * n, lambda a, b: _fill_forward((a, b)), keyp, pay)
        del pk, x, y, fk, k2, pay, keyp

    # filter (BM_Filter SF 8: 64Mi rows) and exact sum (BM_Sum SF 32: 64Mi)
    v = u32(64 * MI, 40)
    report("filter_compact_64Mi", 64 * MI, lambda a: filter_compact(a), v)
    report("filter_with_indices_64Mi", 64 * MI, lambda a: filter_with_indices(a), v)
    report("sum_u64_64Mi", 64 * MI, sum_u64_pair, v)
    # shuffle cells: one device's 64Mi rows into 4 partitions (4-card shape)
    cell = 32 * MI
    report("partition_cells_p4_64Mi", 64 * MI,
           lambda a, b: local_fragments(a, (b,), 4, cell), v, u32(64 * MI, 41))
    del v

    # take: BM_Take (4Mi data / 512Ki indices) and a 64Mi table beyond L2
    for n in (4 * MI, 64 * MI):
        data = u32(n, 50)
        idx = u32(MI // 2, 51, n).astype(jnp.int32)
        moved = 3 * idx.size * 4  # indices, gathered elements, output
        report(f"take_op_{n // MI}Mi", n, take, data, idx, moved=moved)

    # sorted hash table: build + binary-search probe (run_benchmarks shape)
    for n in (1 * MI, 16 * MI):
        keys = jax.random.permutation(jax.random.fold_in(key, 60), n).astype(jnp.uint32)
        vals = u32(n, 61)
        report(f"ht_build_sorted_{n // MI}Mi", n, ht_build_sorted, keys, vals)
        table = ht_build_sorted(keys, vals)
        report(f"ht_probe_sorted_{n // MI}Mi", n, ht_probe_sorted, table, keys)


if __name__ == "__main__":
    main()
