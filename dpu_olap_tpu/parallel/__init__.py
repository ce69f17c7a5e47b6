"""Device-mesh runtime and distributed shuffle.

The replacement for the reference's host/dpuext runtime + shuffle
engine (SURVEY §5.8): the DpuSet rank tree becomes a jax.sharding.Mesh, the
push/sg transfers become shardings + a padded ragged all-to-all, and the
async rank-callback pipeline becomes XLA async dispatch.
"""

from .mesh import DeviceSet  # noqa: F401
from .shuffle import shuffle_partitions, ShuffleResult  # noqa: F401
from .dist_join import dist_join  # noqa: F401
