"""The closure kernel's share of its roofline: the least time the card
could take to read each dependency graph's bool adjacency and write its
closure once (``2 * B * N * N`` bytes), at 3.35 TB/s, over the kernel's
device time, per launch.  EPaxos closes every replica's window graph of
every group each round: ``B = R * G`` graphs of ``N = R * I`` nodes (500k
graphs of 80 at 5 replicas, 16 instances and 100k groups: 6.4 GB, 1.91
ms).  No operation term: the data sheet gives no int32 ALU peak, and the
operations depend on the kernel's variant."""

from simbench.peaks import HBM_BYTES_PER_S


def needed_bytes(graphs: int, nodes: int) -> int:
    return 2 * graphs * nodes * nodes


def read(r):
    us, launches = r.kernel_us("closure_kernel", "closure_block_kernel")
    if us <= 0 or launches <= 0:
        return None
    s = r.shapes
    graphs = s["replicas"] * s["groups"]
    nodes = s["replicas"] * s["n_slots"]
    least_s = needed_bytes(graphs, nodes) * launches / HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
