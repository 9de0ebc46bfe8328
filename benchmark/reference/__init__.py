"""The plain reference the benchmark holds the port's answers against
(NumPy only; it imports neither JAX nor anything of the port)."""
