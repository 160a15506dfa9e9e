"""Sharding over several devices with torch.distributed: one process per
device, every rank running the same code on its shard (SPMD).  `mesh`
holds the mesh and the sharded commit and LogUp steps, `dist_ntt` the
four-step NTT with its explicit all-to-alls and the row moves between
ranks, `dryrun` the process launcher, the multi-device dry run and a
distributed prove (machine/jit_prover.py's `prove_jit(mesh=)`)."""
