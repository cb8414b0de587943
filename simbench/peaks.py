"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80GB data sheet: 3.35 TB/s of HBM3 bandwidth.  The data
sheet gives no int32 ALU peak, so the simulator's kernels are held to the
bytes their work needs and to nothing else.  The rates assume the card's
full 700 W power limit; the result line carries the card's own limit.
"""

HBM_BYTES_PER_S = 3.35e12
