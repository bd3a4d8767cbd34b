"""maelstrom_tpu_torch: the PyTorch / CUDA port of maelstrom_tpu.

The JAX package `maelstrom_tpu` stays the reference; this package imports
nothing of it, nor JAX. Slice 1 ports the single-cluster broadcast round
on the static edge channels (`sim.make_sim`, `sim.make_run_fn`,
`bench.run_broadcast_bench`); slice 2 the scan-ahead (`sim.make_scan_fn`)
and the CLI runner (`python -m maelstrom_tpu_torch test -w broadcast`,
`runner.tpu_runner.run_tpu_test`), with copies of the host modules the
runner needs; slice 3 the threefry PRNG (`prng`, bit for bit with
`jax.random`), loss, randomized latency and the partition, kill, pause,
duplicate and weather nemeses (`nemesis`); slice 4 Raft serving lin-kv
(`nodes/raft.py`, `python -m maelstrom_tpu_torch test -w lin-kv`) and the
cluster axis (`parallel`, `bench --raft`); slice 5 the pool-path round
(`sim._round_pool`) with echo and unique-ids, and the CRDT programs
g-set, pn-counter and g-counter, with their workloads and checkers.
Hand-written CUDA kernels (`csrc/`, `kernels/`) carry the edge exchange,
the gossip step (with its stall mask), the reply compaction, the scan's
reply log (with bit-packed or int32 payloads), the quiescence probe, the
random draws, the edge fault masks, the spill write, the Raft step, the
echo and unique-ids steps and the PN-counter step. Entry points run on
the CUDA device unless the caller passes
`device="cpu"` (`--device cpu`), where the kernels' plain PyTorch
versions run."""
