"""CP experiment engine (the per-PDE experiment scripts come with the solvers)."""
