"""Frozen yardsticks: operations and bytes of the chain replay
(``chain``), FLOPs counted on the reference (``flops``), published H100
peaks (``peaks``)."""
