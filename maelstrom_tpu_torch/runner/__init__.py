"""Test runners of the port (`tpu_runner`: the single-cluster runner)."""
