"""The benchmark of paxi_tpu_torch: lock-step replication groups on one
card, driven and judged by the files of this folder."""
