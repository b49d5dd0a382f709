"""Physical operators."""
