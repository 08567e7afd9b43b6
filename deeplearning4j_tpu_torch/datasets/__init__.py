"""Dataset containers and iterators (host numpy arrays)."""
