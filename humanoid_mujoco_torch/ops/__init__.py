"""Small compute ops: Cholesky, splines, penalty norms."""
