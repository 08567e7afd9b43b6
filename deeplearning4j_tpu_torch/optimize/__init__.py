"""Training-loop pieces: the solver step and training listeners."""
