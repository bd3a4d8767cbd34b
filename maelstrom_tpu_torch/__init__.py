"""maelstrom_tpu_torch: the PyTorch / CUDA port of maelstrom_tpu.

The JAX package `maelstrom_tpu` stays the reference; this package imports
nothing of it, nor JAX. This slice ports the single-cluster broadcast
round on the static edge channels (`sim.make_sim`, `sim.make_run_fn`,
`bench.run_broadcast_bench`), with hand-written CUDA kernels for the edge
exchange, the gossip step and the reply compaction (`csrc/`,
`kernels/`). Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where the kernels' plain PyTorch versions run."""
