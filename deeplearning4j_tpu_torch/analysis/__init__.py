"""Static-analysis findings: the shared ``Finding`` model and the
process-global findings log (``analysis.findings``), where the serving
platform records a truncated warmup (PLT301). The JAX package's program
and source linters are not ported."""
