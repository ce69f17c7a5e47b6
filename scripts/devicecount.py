#!/usr/bin/env python3
"""Device inventory (reference scripts/dpucount.py analog: allocate-all and
report the count; here the fleet is the JAX device set, with platform and
per-device attributes — the 'how much hardware do I have' probe)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import jax

    devices = jax.devices()
    print(f"{len(devices)} devices allocated ({devices[0].platform})")
    for d in devices:
        kind = getattr(d, "device_kind", "?")
        mem = getattr(d, "memory_stats", lambda: None)()
        hbm = f", {mem['bytes_limit'] / 2**30:.1f} GiB HBM" if mem else ""
        print(f"  [{d.id}] {kind} process={d.process_index}{hbm}")


if __name__ == "__main__":
    main()
