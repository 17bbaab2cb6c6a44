"""Workloads of the port: the causal-LM trainer (``transformer``)."""
