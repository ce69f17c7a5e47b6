"""Operator drivers: the reference's uniform operator protocol.

Every operator follows ctor(device_set, inputs...) -> Prepare() -> Run() ->
Timers() (reference host/filter/filter_dpu.h:14-29, host/join/join_dpu.h),
with a device variant (the ``*Tpu`` classes: device mesh execution) and a
Native variant (pyarrow on CPU — the golden-result oracle, like the
reference's Arrow ExecPlan baselines).
"""

from .filter_op import FilterNative, FilterTpu  # noqa: F401
from .take_op import TakeNative, TakeTpu  # noqa: F401
from .aggr_op import SumNative, SumTpu  # noqa: F401
from .join_op import JoinNative, JoinTpu  # noqa: F401
from .partition_op import PartitionTpu  # noqa: F401
