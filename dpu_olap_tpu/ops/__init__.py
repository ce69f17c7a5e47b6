"""Device ops: the XLA compute path.

Each module is the re-expression of one reference DPU kernel
(dpu/shared/kernels/*) or device library (dpu/shared/hashtable):

  hashing    - Wang hash + radix bucket mapping  (partition.c:20-49)
  filter     - stable predicate compaction       (filter.c)
  take       - gather                            (take.c)
  aggregate  - exact uint64 sum of uint32        (aggr.c + aggr/main.c)
  partition  - radix hash partition              (partition.c)
  hashtable  - sorted-store + cuckoo hash tables (hashtable.c redesigned)
  join       - build+probe+take single-shard join (join/main.c pipeline)
"""

from .hashing import wang_hash, radix_bucket  # noqa: F401
from .filter import filter_compact, filter_count  # noqa: F401
from .take import take  # noqa: F401
from .aggregate import sum_u64, sum_u64_pair  # noqa: F401
from .partition import radix_partition  # noqa: F401
from .hashtable import (  # noqa: F401
    HashTable,
    SortedTable,
    ht_build,
    ht_build_sorted,
    ht_probe,
    ht_probe_sorted,
    ht_probe_sorted_stream,
)
from .join import join_shard  # noqa: F401
