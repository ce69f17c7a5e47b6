"""Arrow-layout columnar Batch/Table over JAX arrays.

The replacement for the reference's use of ``arrow::RecordBatch``
on the host plus raw MRAM buffers on the device (host/dpuext/arrow_utils.cc:
columns are fixed-width primitive buffers moved wholesale). Here a column is a
device-resident ``jax.Array``; batches are dicts of equally-long columns, with
zero-copy pyarrow interop on the host side.

Only fixed-width primitive types are supported — the same restriction the
reference enforces (host/dpuext/arrow_utils.cc:41-45 ``get_byte_width`` aborts
on non-fixed-width types).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

try:  # pyarrow is optional at runtime; required for the Arrow bridge + oracles
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


_ARROW_TO_NP = {
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "uint64": np.uint64,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "float": np.float32,
    "double": np.float64,
}


@dataclasses.dataclass
class Batch:
    """A record batch: named, equally-long, device-resident columns."""

    columns: Dict[str, jax.Array]

    def __post_init__(self):
        lengths = {k: int(v.shape[0]) for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged batch: {lengths}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).shape[0])

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> jax.Array:
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names})

    def add_column(self, name: str, col: jax.Array, index: int | None = None) -> "Batch":
        """Insert a column (reference generator::AddColumn inserts at index 0,
        host/generator/generator.cc:32-44)."""
        items = list(self.columns.items())
        if index is None:
            index = len(items)
        items.insert(index, (name, col))
        return Batch(dict(items))

    def take(self, indices: jax.Array) -> "Batch":
        return Batch({n: jnp.take(c, indices, axis=0) for n, c in self.columns.items()})

    def slice(self, start: int, length: int) -> "Batch":
        return Batch({n: c[start : start + length] for n, c in self.columns.items()})

    # ---- host interop ------------------------------------------------------

    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray], device=None) -> "Batch":
        """Wrap host columns. With device=None the columns stay HOST-resident
        (numpy) — batches are the host-side Arrow data of the reference, and
        operators move rounds to the device explicitly (the copy-to-dpu
        step); jnp ops on them still auto-transfer for ad-hoc use. Pass a
        device to eagerly place (e.g. tests pinning a mesh)."""
        if device is not None:
            return Batch(
                {n: jax.device_put(np.ascontiguousarray(c), device)
                 for n, c in columns.items()}
            )
        return Batch({n: np.ascontiguousarray(c) for n, c in columns.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {n: np.asarray(c) for n, c in self.columns.items()}

    @property
    def is_device(self) -> bool:
        """True when every column is a device-resident jax.Array (operator
        outputs that have NOT been materialized to the host — the
        reference's results-stay-on-DPU-until-final-gather contract,
        host/dpuext/dpuext.hpp:859-875)."""
        return bool(self.columns) and all(
            isinstance(c, jax.Array) for c in self.columns.values()
        )

    @staticmethod
    def from_arrow(rb: "pa.RecordBatch", device=None) -> "Batch":
        """Zero-copy (host side) import of a pyarrow RecordBatch."""
        cols = {}
        for name, col in zip(rb.schema.names, rb.columns):
            if col.null_count:
                raise ValueError("null values not supported (reference: non-nullable)")
            cols[name] = col.to_numpy(zero_copy_only=True)
        return Batch.from_numpy(cols, device=device)

    def to_arrow(self) -> "pa.RecordBatch":
        np_cols = self.to_numpy()
        arrays = [pa.array(c) for c in np_cols.values()]
        return pa.RecordBatch.from_arrays(arrays, names=list(np_cols.keys()))


class Table:
    """A sequence of batches with a common schema (arrow::Table analog)."""

    def __init__(self, batches: Iterable[Batch]):
        self.batches: List[Batch] = list(batches)

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def names(self) -> List[str]:
        return self.batches[0].names if self.batches else []

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def __getitem__(self, i: int) -> Batch:
        return self.batches[i]

    def concat(self) -> Batch:
        # Host-resident columns concatenate in numpy: jnp.concatenate would
        # silently downcast 64-bit columns to 32 bits (x64 is disabled) —
        # the u64 lo/hi-plane join split needs the full-width host column.
        def cat(cols):
            if all(isinstance(c, np.ndarray) for c in cols):
                return np.concatenate(cols)
            return jnp.concatenate(cols)

        return Batch(
            {n: cat([b[n] for b in self.batches]) for n in self.names}
        )

    @property
    def is_device(self) -> bool:
        """True when every batch is device-resident (see Batch.is_device)."""
        return bool(self.batches) and all(b.is_device for b in self.batches)

    def to_host(self) -> "Table":
        """Materialize every column to host numpy (the final gather). Lazy
        counterpart of the device-resident result contract: operators and
        plan nodes hand device Tables to each other and only a consumer
        that actually leaves the device pays the transfer."""
        return Table(
            [Batch({n: np.asarray(c) for n, c in b.columns.items()})
             for b in self.batches]
        )

    def to_arrow(self) -> "pa.Table":
        return pa.Table.from_batches([b.to_arrow() for b in self.batches])

    @staticmethod
    def from_arrow(t: "pa.Table", device=None) -> "Table":
        return Table([Batch.from_arrow(rb, device=device) for rb in t.to_batches()])
