"""The least bytes any exact solve must move, counted from the graph and
the reference's reach, the table of peaks they are held against, and the
names of the program's relax kernels whose device time they are held to.

A solve from a root must read, once, the 4-byte target and 4-byte weight of
every arc whose tail it reaches, and the row offset of every vertex it
reaches, and write each reached vertex's 4-byte label.  The count depends
on the graph and the root alone, never on a kernel's launches, so it reads
the same work whatever relax kernel answers.
"""
from __future__ import annotations

#: the relax kernels of the program's CSR engines (``csrc/*.cu``), by the
#: short name ``trace.short_name`` gives their device events
RELAX_KERNELS = frozenset({
    "frontier_push_kernel", "frontier_push_labels_kernel",
    "frontier_gather_kernel", "bucket_relax_kernel", "ell_relax_kernel"})

#: HBM bytes per second, by a fragment of the device name, from NVIDIA's
#: data sheets (dense, at the card's full power limit).
PEAK_BYTES_PER_S = (
    ("H100 80GB HBM3", 3.35e12),     # H100 SXM5
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
)

ARC_BYTES = 8          # target id + weight
VERTEX_BYTES = 8       # row offset read + label written


def peak_bytes_per_s(device_name: str):
    """The data-sheet bandwidth of ``device_name``, or None if the table
    does not hold it (the roofline metric is then left out)."""
    for frag, bw in PEAK_BYTES_PER_S:
        if frag in device_name:
            return bw
    return None


def least_bytes(vertices: int, arcs: int) -> int:
    """Bytes a solve that reaches ``vertices`` vertices holding ``arcs``
    arcs must move at least."""
    return ARC_BYTES * int(arcs) + VERTEX_BYTES * int(vertices)
