"""Workload modules of the port (TPC-H lineitem)."""
