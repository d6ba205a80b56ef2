"""The benchmark's plain reference: a frozen copy of the port's plain
stages (``ptrt_tpu_torch``'s ``<name>_plain`` versions and the modules they
use), with its own scene description, triangle table and brute-force
walks.  It imports nothing of the port, and the port's kernels never run
in it."""
