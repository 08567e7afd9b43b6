"""Model runtimes (reference: ``.../nn/graph/``): the serving slice holds
``ComputationGraph``'s eval-mode forward."""
