"""Workloads of the port (topologies only in this slice)."""
