"""Resilience for the serving path: circuit breaker, retry policy and
deterministic fault injection (copies of the JAX package's modules, which
import no jax)."""
