"""Cost model of the paper's testbed (disk, network, CPU)."""
