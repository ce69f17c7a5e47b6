"""dpu_olap_tpu — a vectorized query-execution framework in JAX.

A JAX/XLA re-design of the capabilities of upmem/dpu_olap: columnar SQL
compute operators — filter, take (gather), sum-aggregate, radix
hash-partition, and partitioned hash join (build + probe + take) — executed
over device-resident Arrow-layout columnar batches on one GPU or a mesh of
GPUs.

Architecture (a re-design, not a port):
  - ``ops/``       device ops: XLA compute paths (the equivalent of the
                   reference's DPU C kernels, ``dpu/shared/kernels/*``).
  - ``parallel/``  device mesh runtime + distributed all-to-all shuffle
                   (the equivalent of ``host/dpuext`` + ``host/partition``).
  - ``backend``    the one module that knows the platform: supported
                   platforms, device memory budgets, compile cache.
  - ``operators/`` operator drivers with the reference's uniform
                   Prepare()/Run()/Timers() protocol (``host/{filter,join,...}``).
  - ``native/``    C++ host runtime: parallel memcpy, partition slabs, timers,
                   ordered async executor (``host/memory_utils``, ``host/timer``).
  - ``columnar``   Arrow-layout Batch/Table over JAX arrays with pyarrow interop.
  - ``generator``  seeded data generation replicating host/generator semantics.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .columnar import Batch, Table  # noqa: F401


def __getattr__(name):
    # Lazy convenience exports (avoid importing jax-heavy modules eagerly).
    if name == "DeviceSet":
        from .parallel.mesh import DeviceSet

        return DeviceSet
    if name == "plan":
        import importlib

        return importlib.import_module(".plan", __name__)
    raise AttributeError(name)
