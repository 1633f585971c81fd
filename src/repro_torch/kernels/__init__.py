"""Hand-written Hopper kernels (csrc/), their wrappers (ops.py), plain
versions (ref.py), builder (build.py) and backend selection (backend.py)."""
